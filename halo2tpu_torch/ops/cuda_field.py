"""Montgomery multiply and power, add / sub / neg mod p and the scans:
the CUDA kernels (csrc/mont_mul.cu, csrc/field_addsub.cu,
csrc/field_linscan.cu) and their plain torch versions.  Counterparts of
halo2tpu/ops/pallas_field.py, of halo2tpu/fields/jfield.py::mont_pow, add,
sub, neg, _prefix_sum_mod, suffix_sum_mod and _prefix_prod, and of the
scans inside halo2tpu/plonk/engine.py::_div_linear_jit, _eval_group_jit
and _gp_chunk_jit.

`mont_mul`, `mont_pow`, `add_sub` (behind `add`, `sub` and `neg`),
`linscan` and `prodscan` launch their kernels for CUDA tensors and take the
plain versions only for CPU tensors.  The plain versions work on any device
(chip_smoke.py compares them with the kernels on the card;
`linscan_plain.cuda_calls` and `prodscan_plain.cuda_calls` count their runs
on CUDA tensors).  Beside its count of launches, each wrapper keeps
`shapes`, a histogram of what it launched: (lanes,), (lanes, "add" | "sub"
| "neg") for add_sub, and (n, columns, output, "one" | "a" | "prod") for
linscan and prodscan.

Field constants come from a halo2tpu_torch.fields.jfield.FieldSpec.
"""
from __future__ import annotations

from collections import Counter

import ctypes
import math

import torch
import torch.nn.functional as F

NLIMB = 8
MASK = 0xFFFFFFFF
_M16 = 0xFFFF

_AUX: dict = {}


def _aux(name: str, k: int, device) -> torch.Tensor:
    key = (name, k, device)
    t = _AUX.get(key)
    if t is None:
        idx = torch.arange(k, dtype=torch.int64, device=device)
        t = (torch.ones_like(idx) << idx) if name == "pow2" else idx
        _AUX[key] = t
    return t


def carry_in(gen: torch.Tensor, prop: torch.Tensor) -> torch.Tensor:
    """Carry chain over the last axis (K <= 62 limbs) as one parallel
    prefix: limb i generates a carry (gen) or passes its incoming carry on
    (prop).  Returns (..., K + 1) 0/1: the carry INTO each limb, then the
    carry out of the top limb.  With G, P the bit masks, the carries are
    ((G | P) + G) ^ P: the sum bit of limb i is p_i ^ carry_i."""
    k = gen.shape[-1]
    w = _aux("pow2", k, gen.device)
    g = (gen * w).sum(-1)
    x = ((gen | prop) * w).sum(-1)
    c = (x + g) ^ (x - g)
    return (c.unsqueeze(-1) >> _aux("idx", k + 1, gen.device)) & 1


def _split16(x):
    """(..., 8) int32 limbs -> (..., 16) int64 16-bit sub-limbs."""
    x64 = x.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([x64 & _M16, x64 >> 16], -1).flatten(-2)


def _join16(r):
    """(..., 16) exact 16-bit limbs (int64) -> (..., 8) int32 limbs."""
    r = r.unflatten(-1, (NLIMB, 2))
    v = r[..., 0] | (r[..., 1] << 16)
    return (v - ((v >> 31) << 32)).to(torch.int32)


def _norm16(c, rounds: int = 2):
    """Lazy nonnegative columns (< 2^40) -> exact 16-bit limbs (same width,
    value mod 2^(16 K)).  Each round moves every column's excess up one
    column (the top column's excess is dropped); after two rounds every
    column is < 2^16 + 2^9, so each carries at most 1 out and one parallel
    carry chain finishes."""
    for _ in range(rounds):
        hi = c >> 16
        c = c & _M16
        c[..., 1:] += hi[..., :-1]
    cin = carry_in(c > _M16, c == _M16)
    return (c + cin[..., :-1]) & _M16


def _matmul_exact(x, m):
    """x (..., k) int64 @ m (k, j) float64 for integer operands whose
    partial sums stay below 2^53: exact in float64 on any device."""
    return (x.to(torch.float64) @ m).to(torch.int64)


# mont_mul_plain's route for CPU int32 operands: the same SOS steps on
# python's 256-bit integers, lane by lane, two to three times faster there
# than the float64 convolutions at every width.  It buys the CPU test suite
# its time: every CPU proof of the tests runs its products through it, and
# the whole suite (tests/, 6 xdist workers) took 896 s with this route off
# against 527-581 s with it, of a 1470 s limit.  CUDA tensors keep the
# torch route, which chip_smoke.py times as each kernel's plain version.
_W256 = (1 << 256) - 1
_W512 = (1 << 512) - 1


def _cpu_ints(*ts) -> bool:
    """Non-empty int32 CPU operands: mont_mul_plain's python-int route."""
    return all(t.device.type == "cpu" and t.dtype == torch.int32
               and t.numel() for t in ts)


def _lane_ints(x) -> list:
    """(..., 8) int32 limbs -> python ints, lane by lane."""
    raw = x.contiguous().numpy().tobytes()
    return [int.from_bytes(raw[i:i + 32], "little")
            for i in range(0, len(raw), 32)]


def _from_lane_ints(vals, shape):
    buf = b"".join([v.to_bytes(32, "little") for v in vals])
    return torch.frombuffer(bytearray(buf), dtype=torch.int32).reshape(shape)


def _lanewise(fn, *ts):
    """fn over the lanes' python ints of the broadcast operands."""
    ts = torch.broadcast_tensors(*ts)
    return _from_lane_ints([fn(*v) for v in zip(*map(_lane_ints, ts))],
                           ts[0].shape)


def _mont_int(spec, x: int, y: int) -> int:
    """The kernel's Montgomery product on python ints, any x, y < 2^256:
    m = t * (-p^-1) mod 2^256, (t + m p) mod 2^512 over 2^256, one
    conditional subtraction."""
    t = x * y
    u = ((t + ((t * spec.ninv256) & _W256) * spec.p) & _W512) >> 256
    return u - spec.p if u >= spec.p else u


def mont_mul_plain(spec, a, b):
    """a * b * 2^-256 mod p in plain torch: SOS reduction over 16-bit
    sub-limbs (a 32 x 32-bit product would overflow signed int64).  Every
    convolution is a float64 matrix product whose partial sums are integers
    below 2^36, so it is exact.  Canonical output, bit-identical to the
    kernel.  CPU operands take the same steps on python ints."""
    if _cpu_ints(a, b):
        return _lanewise(lambda x, y: _mont_int(spec, x, y), a, b)
    dev = a.device
    a16 = _split16(a).to(torch.float64)
    b16 = _split16(b).to(torch.float64)
    outer = a16.unsqueeze(-1) * b16.unsqueeze(-2)          # (..., 16, 16)
    T = (outer.flatten(-2) @ spec.const("diag_sum", dev)).to(torch.int64)
    tl = _norm16(T[..., :16])                           # T mod 2^256
    m = _norm16(_matmul_exact(tl, spec.const("pinv_t", dev)))
    mp = _matmul_exact(m, spec.const("p_t", dev))          # (..., 31)
    Z = _norm16(F.pad(T + mp, (0, 1)))                  # (..., 32)
    r = Z[..., 16:]                      # Z / 2^256 < 2p < 2^255
    t = r - spec.const("p16", dev)
    bb = carry_in(t < 0, t == 0)
    d = (t - bb[..., :-1]) & _M16
    r = torch.where(bb[..., -1:] == 0, d, r)
    return _join16(r)


def mont_mul(spec, a, b):
    """Lanewise Montgomery product of (..., 8) int32 tensors (broadcast).
    CUDA tensors launch the kernel; CPU tensors take mont_mul_plain.  When
    a and b are one buffer the kernel takes its squaring (same bits)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_plain(spec, a, b)
    if a.device != b.device or a.device.type != "cuda":
        raise ValueError(f"mont_mul: operands on {a.device} and {b.device}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("mont_mul: operands must be int32 limb tensors")
    if a.shape[-1] != NLIMB or b.shape[-1] != NLIMB:
        raise ValueError(f"mont_mul: limb axis must be {NLIMB}")
    from .._build import check, lib
    a, b = torch.broadcast_tensors(a, b)
    a = a.contiguous()
    b = b.contiguous()
    out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    n = a.numel() // NLIMB
    stream = torch.cuda.current_stream(a.device).cuda_stream
    check(lib().h2_mont_mul(a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
                            spec.mod_words_ptr, stream), "mont_mul")
    mont_mul.launches += 1
    mont_mul.shapes[(n,)] += 1
    return out


mont_mul.launches = 0
mont_mul.shapes = Counter()


def mont_pow_plain(spec, a, e: int):
    """a^e lanewise for a python-int exponent: square-and-multiply from the
    lowest bit, one mont_mul_plain a product or squaring."""
    result = spec.const("one_mont", a.device).expand(a.shape)
    base = a
    while e:
        if e & 1:
            result = mont_mul_plain(spec, result, base)
        e >>= 1
        if e:
            base = mont_mul_plain(spec, base, base)
    return result


FE_POW_RING = 7        # kRing: the slots between the kernel's two warps


def mont_pow(spec, a, e: int):
    """a^e lanewise, (..., 8) int32 limbs, 0 <= e < 2^256.  A CUDA tensor
    takes one launch of the kernel (the whole square-and-multiply chain on
    two warps a block of 32 lanes: csrc/mont_mul.cu); a CPU tensor takes
    mont_pow_plain."""
    if not 0 <= e < 1 << 256:
        raise ValueError("mont_pow: exponent out of [0, 2^256)")
    if a.device.type == "cpu":
        return mont_pow_plain(spec, a, e)
    if a.device.type != "cuda":
        raise ValueError(f"mont_pow: operand on {a.device}")
    if a.dtype != torch.int32 or a.shape[-1] != NLIMB:
        raise TypeError("mont_pow: operand must be an int32 limb tensor")
    from .._build import check, lib
    a = a.contiguous()
    out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    n = a.numel() // NLIMB
    words = (ctypes.c_uint32 * NLIMB)(*[(e >> (32 * i)) & 0xFFFFFFFF
                                         for i in range(NLIMB)])
    stream = torch.cuda.current_stream(a.device).cuda_stream
    check(lib().h2_mont_pow(a.data_ptr(), out.data_ptr(), n,
                            ctypes.addressof(words), e.bit_length(),
                            spec.mod_words_ptr, stream), "mont_pow")
    mont_pow.launches += 1
    mont_pow.shapes[(n,)] += 1
    return out


mont_pow.launches = 0
mont_pow.shapes = Counter()


def mont_chain_plain(spec, x, y, steps: int, square: bool = False):
    """mont_chain in plain torch: `steps` dependent mont_mul_plain."""
    for _ in range(steps):
        x = mont_mul_plain(spec, x, x if square else y)
    return x


def mont_chain(spec, x, y, steps: int, square: bool = False):
    """Lanewise x * y * ... * y (`steps` dependent Montgomery products), or
    x squared `steps` times, over (L, 8) int32 limbs: on CUDA tensors one
    thread a lane of the mont_chain kernel, a probe that no path launches
    (its one-lane time is the unit of the latency floors in
    chip_smoke.py); on CPU tensors the plain chain."""
    if x.dim() != 2 or x.shape[1] != NLIMB or y.shape != x.shape or (
            x.dtype != torch.int32):
        raise ValueError(f"mont_chain: expected two (L, 8) int32 stacks, "
                         f"got {tuple(x.shape)}, {tuple(y.shape)}")
    if x.device.type == "cpu":
        return mont_chain_plain(spec, x, y, steps, square)
    from .._build import check, lib
    x, y = x.contiguous(), y.to(x.device).contiguous()
    out = torch.empty_like(x)
    check(lib().h2_mont_chain(x.data_ptr(), y.data_ptr(), out.data_ptr(),
                              x.shape[0], steps, int(square),
                              spec.mod_words_ptr,
                              torch.cuda.current_stream(x.device).cuda_stream),
          "mont_chain")
    return out


# -- add / sub / neg ---------------------------------------------------------

def u64(x: torch.Tensor) -> torch.Tensor:
    """int32 limbs -> int64 holding the uint32 values."""
    return x.to(torch.int64) & MASK


def i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 bit patterns."""
    return (v - ((v >> 31) << 32)).to(torch.int32)


def _add_limbs(x, y):
    """x + y over 32-bit limbs (int64 carriers): (limbs, carry out)."""
    s = x + y
    lo = s & MASK
    c = carry_in(s > MASK, lo == MASK)
    return (lo + c[..., :-1]) & MASK, c[..., -1]


def _sub_limbs(x, y):
    """x - y over 32-bit limbs: (limbs mod 2^256, borrow out)."""
    t = x - y
    b = carry_in(t < 0, t == 0)
    return (t - b[..., :-1]) & MASK, b[..., -1]


def add_plain(spec, a, b):
    """a + b mod p in plain torch (CPU torch has no uint32 add, shift or
    compare, so limbs are widened to int64): one conditional subtraction,
    as the kernel's."""
    s, top = _add_limbs(u64(a), u64(b))
    d, borrow = _sub_limbs(s, spec.const("p64", s.device))
    ge = (top == 1) | (borrow == 0)
    return i32(torch.where(ge.unsqueeze(-1), d, s))


def sub_plain(spec, a, b):
    """a - b mod p in plain torch, inputs canonical."""
    d, borrow = _sub_limbs(u64(a), u64(b))
    e, _ = _add_limbs(d, spec.const("p64", d.device))
    return i32(torch.where((borrow == 1).unsqueeze(-1), e, d))


def neg_plain(spec, a):
    return sub_plain(spec, torch.zeros_like(a), a)


ADD, SUB, NEG = 0, 1, 2
_OP_NAMES = ("add", "sub", "neg")
_PLAIN = (add_plain, sub_plain, neg_plain)


def _operand(x, shape):
    """x broadcast to `shape` (..., 8) as the kernel reads it: (tensor,
    div, mod), lane i of the output reading element (i // div) % mod of the
    tensor.  That holds when the axes x does not broadcast over are one
    block laid out contiguously; any other operand is copied out whole."""
    if x.shape == shape and x.is_contiguous():
        return x, 1, x.numel() // NLIMB
    v = x.expand(shape)
    sizes, strides = shape[:-1], v.stride()[:-1]
    live = [d for d, n in enumerate(sizes) if n > 1 and strides[d] != 0]
    lo, hi = (live[0], live[-1] + 1) if live else (0, 0)
    ok, inner = v.stride(-1) == 1, NLIMB
    for d in range(hi - 1, lo - 1, -1):
        if sizes[d] > 1:
            ok = ok and strides[d] == inner
            inner *= sizes[d]
    if not ok:
        v, lo, hi = v.contiguous(), 0, len(sizes)
    return v, math.prod(sizes[hi:]), math.prod(sizes[lo:hi])


def add_sub(spec, op: int, a, b=None):
    """Lanewise a + b (op ADD), a - b (SUB) or -a (NEG) mod p of (..., 8)
    int32 tensors (broadcast), canonical.  CUDA tensors launch the kernel;
    CPU tensors take add_plain / sub_plain / neg_plain.  Same-shape
    contiguous CUDA operands (most launches of a proof) take a short path
    that skips the broadcast layout."""
    if op == NEG:
        b = a
    if (a.is_cuda and a.shape == b.shape and a.dtype == b.dtype == torch.int32
            and a.shape[-1] == NLIMB and a.device == b.device
            and a.is_contiguous() and b.is_contiguous()):
        out = torch.empty_like(a)
        n = out.numel() // NLIMB
        if n:
            _launch_addsub(spec, op, a, 1, n, b, 1, n, out, n)
        return out
    ts = (a,) if op == NEG else (a, b)
    if all(t.device.type == "cpu" for t in ts):
        return _PLAIN[op](spec, *ts)
    if any(t.device != a.device for t in ts) or a.device.type != "cuda":
        raise ValueError(f"{_OP_NAMES[op]}: operands on "
                         f"{[str(t.device) for t in ts]}")
    if any(t.dtype != torch.int32 or t.shape[-1] != NLIMB for t in ts):
        raise TypeError(f"{_OP_NAMES[op]}: operands must be int32 limb "
                        "tensors")
    shape = torch.broadcast_shapes(*(t.shape for t in ts))
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    n = out.numel() // NLIMB
    if n == 0:
        return out
    av, adiv, amod = _operand(a, shape)
    bv, bdiv, bmod = (av, adiv, amod) if op == NEG else _operand(b, shape)
    _launch_addsub(spec, op, av, adiv, amod, bv, bdiv, bmod, out, n)
    return out


def _launch_addsub(spec, op, a, adiv, amod, b, bdiv, bmod, out, n):
    from .._build import check, lib
    stream = torch.cuda.current_stream(out.device).cuda_stream
    check(lib().h2_field_addsub(a.data_ptr(), adiv, amod, b.data_ptr(), bdiv,
                                bmod, out.data_ptr(), n, op,
                                spec.mod_words_ptr, stream), "field_addsub")
    add_sub.launches += 1
    add_sub.shapes[(n, _OP_NAMES[op])] += 1


add_sub.launches = 0
add_sub.shapes = Counter()


def add(spec, a, b):
    return add_sub(spec, ADD, a, b)


def sub(spec, a, b):
    """a - b mod p, inputs canonical."""
    return add_sub(spec, SUB, a, b)


def neg(spec, a):
    return add_sub(spec, NEG, a)



# -- the scans: sum, linear and product -------------------------------------

SCAN_THREADS = 256     # threads a block (csrc/field_linscan.cu kThreads)
SCAN_LOG = 8           # log2(SCAN_THREADS): the block scan's rounds
SCAN_LOOK = 5          # log2 of the blocks a look-back window reads (a warp)
SCAN_KINDS = ("one", "a")   # field_linscan_kernel's kinds: sum, linear
# elements a thread folds serially.  A sum is adds only.  With a product
# an element (the linear scan) a thread's serial chain is a run's fold, the
# block scan and its rescan: a grid that fits in one wave (SCAN_WAVE blocks
# of 256 threads) is latency-bound, so short runs; a larger grid is
# product-bound, and long runs cut the block scan's products an element
# (8 / run)
SCAN_RUN_ONE = 16
SCAN_RUN_SHORT = 4
SCAN_RUN_LONG = 16
# blocks of the scan kernel the card runs at once: 2 an SM (its launch
# bound), 264 on an H100
SCAN_WAVE = 2 * 132


def scan_shapes(n: int, kind: str, cols: int = 1,
                wave: int = SCAN_WAVE) -> tuple:
    """field_linscan_kernel's schedule for a scan of n elements over `cols`
    columns: (run, blocks a column).  A block covers SCAN_THREADS * run
    elements, the first block padded at its start with zeros."""
    def blocks(run):
        return max(1, -(-n // (SCAN_THREADS * run)))

    if kind == "one":
        run = SCAN_RUN_ONE
    else:
        run = (SCAN_RUN_SHORT if cols * blocks(SCAN_RUN_SHORT) <= wave
               else SCAN_RUN_LONG)
    return run, blocks(run)


def _mont_limbs(spec, v: int) -> list:
    """The Montgomery form of v as eight 32-bit words."""
    m = v * (1 << 256) % spec.p
    return [(m >> (32 * i)) & MASK for i in range(NLIMB)]


_SCAN_POWS: dict = {}


def _scan_pows(spec, a: int, run: int):
    """ctypes words the kernel takes: Montgomery a, a^(run 2^k) for k <
    SCAN_LOG (the block scan's rounds) and A^(2^r) for r <= SCAN_LOOK, A =
    a^(SCAN_THREADS run) (a block's multiplier, the look-back's rounds)."""
    key = (spec.p, a, run)
    words = _SCAN_POWS.get(key)
    if words is None:
        A = pow(a, SCAN_THREADS * run, spec.p)
        vals = ([a] + [pow(a, run << k, spec.p) for k in range(SCAN_LOG)]
                + [pow(A, 1 << r, spec.p) for r in range(SCAN_LOOK + 1)])
        flat = [w for v in vals for w in _mont_limbs(spec, v)]
        words = (ctypes.c_uint32 * len(flat))(*flat)
        if len(_SCAN_POWS) > 256:
            _SCAN_POWS.clear()
        _SCAN_POWS[key] = words
    return words


_LIN_POWS: dict = {}


def _lin_pows(spec, a: int, run: int, device) -> torch.Tensor:
    """(SCAN_THREADS, 8) Montgomery a^(run t) on `device`: the linear
    scan's thread t carries its block's prefix over t runs."""
    key = (spec.p, a, run, device)
    t = _LIN_POWS.get(key)
    if t is None:
        step, v, flat = pow(a, run, spec.p), 1, []
        for _ in range(SCAN_THREADS):
            flat.extend(_mont_limbs(spec, v))
            v = v * step % spec.p
        t = i32(torch.tensor(flat, dtype=torch.int64)).reshape(
            SCAN_THREADS, NLIMB).to(device)
        if len(_LIN_POWS) > 64:
            _LIN_POWS.clear()
        _LIN_POWS[key] = t
    return t


# -- the product scan's kernel (field_linscan_stream_kernel) ----------------

STREAM_THREADS = 128   # threads a unit (kUnitThreads)
STREAM_MAX_RUN = 64    # the longest run (kStreamMaxRun)
# elements a thread folds serially: short runs while the grid fits one wave
# (STREAM_WAVE units: latency-bound), long ones beyond (product-bound: the
# unit's scan costs about 6 / run products an element beside the two of the
# fold and the refold)
STREAM_RUN_SHORT = 4
STREAM_RUN_LONG = 32
# units of the stream kernel the card runs at once: 5 an SM (its launch
# bound, kMinUnits), 660 on an H100
STREAM_WAVE = 5 * 132


def stream_shapes(n: int, cols: int = 1, wave: int = STREAM_WAVE) -> tuple:
    """The stream kernel's schedule for a product scan of n elements over
    `cols` columns: (run, units a column).  A unit covers STREAM_THREADS *
    run elements, the first unit padded at its start with ones."""
    def units(run):
        return max(1, -(-n // (STREAM_THREADS * run)))

    run = (STREAM_RUN_SHORT if cols * units(STREAM_RUN_SHORT) <= wave
           else STREAM_RUN_LONG)
    return run, units(run)


class _LookBack:
    """The look-back scratch of one device and stream, kept across calls:
    a ticket counter, then a status word a block, then two values a block.
    It is zeroed only when it is made; every launch that looks back takes
    a new epoch (the kernel reads a status word only if it carries it) and
    the counter's value before it (tickets count on)."""

    def __init__(self):
        self.cap = 0
        self.buf = None
        self.flag_words = 0
        self.tickets = 0
        self.epoch = 0

    def take(self, blocks: int, device) -> tuple:
        """(tickets, flags, values, ticket base, epoch) for a launch of
        `blocks` blocks."""
        if blocks > self.cap or self.epoch + 1 >= 1 << 30:
            self.cap = max(blocks, 2 * self.cap, 1024)
            self.flag_words = -(-self.cap // 4) * 4
            self.buf = torch.zeros(4 + self.flag_words + 2 * NLIMB * self.cap,
                                   dtype=torch.int32, device=device)
            self.tickets = self.epoch = 0
        self.epoch += 1
        ptr = self.buf.data_ptr()
        return (ptr, ptr + 16, ptr + 4 * (4 + self.flag_words), self.tickets,
                self.epoch)


_LOOKBACK: dict = {}
_SMS: dict = {}


def _sm_count(device) -> int:
    sms = _SMS.get(device)
    if sms is None:
        sms = _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return sms


def _scan_wave(device) -> int:
    """SCAN_WAVE for the card's SM count."""
    return 2 * _sm_count(device)


def _stream_wave(device) -> int:
    """STREAM_WAVE for the card's SM count."""
    return 5 * _sm_count(device)


def linscan_plain(spec, v, a: int = 1, reverse: bool = False,
                  exclusive: bool = False, totals: bool = False):
    """x_j = v_j + a x_(j-1) mod p along axis -2 of v ((n, 8) or (C, n,
    8)), in plain torch: Hillis-Steele rounds, round k adding a^(2^k)
    times the value 2^k rows back (with a = 1, one add a round).  reverse
    runs j from the last row to the first; exclusive gives x_(j-1) at j (0
    at the first); totals only the last x (v.shape[:-2] + (8,))."""
    if v.device.type == "cuda":
        linscan_plain.cuda_calls += 1
    a %= spec.p
    x = v.flip(-2) if reverse else v
    n, shift = x.shape[-2], 1
    while shift < n:
        y = x[..., :n - shift, :]
        if a != 1:
            c = torch.tensor(_mont_limbs(spec, pow(a, shift, spec.p)),
                             dtype=torch.int64, device=v.device)
            y = mont_mul_plain(spec, y, i32(c))
        x = torch.cat([x[..., :shift, :],
                       add_plain(spec, x[..., shift:, :], y)], -2)
        shift *= 2
    if totals:
        return x[..., -1, :].contiguous()
    if exclusive:
        x = torch.cat([torch.zeros_like(x[..., :1, :]), x[..., :-1, :]], -2)
    return (x.flip(-2) if reverse else x).contiguous()


linscan_plain.cuda_calls = 0


def prodscan_plain(spec, r, reverse: bool = False, exclusive: bool = False,
                   totals: bool = False):
    """x_j = r_j x_(j-1) mod p (x_(-1) = 1) along axis -2 of r ((n, 8) or
    (C, n, 8), Montgomery), in plain torch: Hillis-Steele rounds of
    mont_mul_plain.  reverse, exclusive (1 at the first) and totals as in
    linscan_plain."""
    if r.device.type == "cuda":
        prodscan_plain.cuda_calls += 1
    x = r.flip(-2) if reverse else r
    n, shift = x.shape[-2], 1
    while shift < n:
        x = torch.cat([x[..., :shift, :], mont_mul_plain(
            spec, x[..., shift:, :], x[..., :n - shift, :])], -2)
        shift *= 2
    if totals:
        return x[..., -1, :].contiguous()
    if exclusive:
        one = spec.const("one_mont", r.device).expand(x[..., :1, :].shape)
        x = torch.cat([one, x[..., :-1, :]], -2)
    return (x.flip(-2) if reverse else x).contiguous()


prodscan_plain.cuda_calls = 0


def _scan(spec, v, kind: str, a: int, reverse: bool, exclusive: bool,
          totals: bool):
    """One launch of a scan kernel over a CUDA tensor: the product scan on
    field_linscan_stream_kernel, the others on field_linscan_kernel."""
    prod = kind == "prod"
    name = "prodscan" if prod else "linscan"
    if v.device.type != "cuda":
        raise ValueError(f"{name}: operand on {v.device}")
    if v.dtype != torch.int32 or v.dim() not in (2, 3) or v.shape[-1] != NLIMB:
        raise TypeError(f"{name}: need an (n, 8) or (C, n, 8) int32 limb "
                        "tensor")
    x = v if v.dim() == 3 else v.unsqueeze(0)
    cols, n = x.shape[0], x.shape[1]
    if (x.stride(2) != 1 or x.data_ptr() % 16 or x.stride(1) % 4
            or x.stride(0) % 4):
        x = x.contiguous()
    out_shape = v.shape[:-2] + (NLIMB,) if totals else v.shape
    out = torch.empty(out_shape, dtype=torch.int32, device=v.device)
    if n == 0 or cols == 0:
        return out
    if prod:
        run, nb = stream_shapes(n, cols, _stream_wave(v.device))
    else:
        run, nb = scan_shapes(n, kind, cols, _scan_wave(v.device))
    lin = (_lin_pows(spec, a, run, v.device)
           if kind == "a" and nb > 1 and not totals else None)
    from .._build import check, lib
    stream = torch.cuda.current_stream(v.device).cuda_stream
    key = (v.device, stream)
    look = (0, 0, 0, 0, 0)
    if nb > 1:
        state = _LOOKBACK.get(key)
        if state is None:
            state = _LOOKBACK[key] = _LookBack()
        look = state.take(nb * cols, v.device)
    try:
        if prod:
            check(lib().h2_field_linscan_stream(
                x.data_ptr(), x.stride(1), x.stride(0), out.data_ptr(), n,
                cols, run, nb, int(reverse), int(exclusive), int(totals),
                *look, spec.mod_words_ptr, stream),
                f"field_linscan ({name})")
        else:
            check(lib().h2_field_linscan(
                x.data_ptr(), x.stride(1), x.stride(0), out.data_ptr(), n,
                cols, run, nb, int(reverse), int(exclusive), int(totals),
                SCAN_KINDS.index(kind),
                ctypes.addressof(_scan_pows(spec, a, run)),
                0 if lin is None else lin.data_ptr(), *look,
                spec.mod_words_ptr, stream), f"field_linscan ({name})")
    except RuntimeError:
        _LOOKBACK.pop(key, None)
        raise
    if nb > 1:
        state.tickets += nb * cols
    wrapper = prodscan if prod else linscan
    wrapper.launches += 1
    mode = "totals" if totals else "exclusive" if exclusive else "full"
    wrapper.shapes[(n, cols, mode, kind)] += 1
    return out


def linscan(spec, v, a: int = 1, reverse: bool = False,
            exclusive: bool = False, totals: bool = False):
    """The linear scan of linscan_plain.  A CUDA tensor launches the kernel
    once; its (n, 8) rows, or the (n, 8) columns of a (C, n, 8) stack, are
    read in place at any strides that keep each element 16-byte aligned.
    A CPU tensor takes linscan_plain."""
    if v.device.type == "cpu":
        return linscan_plain(spec, v, a, reverse, exclusive, totals)
    a %= spec.p
    return _scan(spec, v, "one" if a == 1 else "a", a, reverse, exclusive,
                 totals)


linscan.launches = 0
linscan.shapes = Counter()


def prodscan(spec, r, reverse: bool = False, exclusive: bool = False,
             totals: bool = False):
    """The product scan of prodscan_plain (prefix products of Montgomery
    values).  A CUDA tensor takes one launch of the stream kernel
    (field_linscan_stream_kernel), at linscan's strides; a CPU tensor takes
    prodscan_plain."""
    if r.device.type == "cpu":
        return prodscan_plain(spec, r, reverse, exclusive, totals)
    return _scan(spec, r, "prod", 1, reverse, exclusive, totals)


prodscan.launches = 0
prodscan.shapes = Counter()
