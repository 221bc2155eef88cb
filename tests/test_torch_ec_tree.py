"""The entries that replace chains of point-kernel launches, on the CPU
(their plain versions): fold_add_tree (the MSM tails' halving rounds),
fold_horner (the MSM Horner combines) and fold_mixed_tiled_rows (msm()'s
row steps).  Each against the chain of entries it replaces, against
halo2tpu (its jpoint.padd halving chain; its host Horner routes) and host
G1 arithmetic, with identity, doubling and inverse lanes; and
fold_add_tree's kernel schedule (which rounds run an add on four slots,
the slots' steps, the last block's merge of a wide group) written out in
torch against the plain chain and halo2tpu's fold_add_any chain.  Exact
equality."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2tpu.curves import g1 as G1
from halo2tpu.curves.jpoint import affine_to_device as jax_affine
from halo2tpu.curves.jpoint import identity_points as jax_identity
from halo2tpu.curves.jpoint import padd as jax_padd
from halo2tpu.curves.jpoint import pdbl as jax_pdbl
from halo2tpu.fields.bn254 import G1_GEN, R
from halo2tpu.ops import msm as jmsm
from halo2tpu_torch import convert
from halo2tpu_torch.curves import jpoint as tjp
from halo2tpu_torch.curves.jpoint import affine_to_device, device_to_affine
from halo2tpu_torch.fields import jfield as tjf
from halo2tpu_torch.fields.jfield import ints_to_limbs
from halo2tpu_torch.ops import cuda_ec
from halo2tpu_torch.ops import msm as tmsm

torch.set_num_threads(1)


def _points(m: int, seed: int):
    rng = np.random.default_rng(seed)
    return [G1.scalar_mul(G1_GEN, int(rng.integers(1, 1 << 30)))
            for _ in range(m)]


def _tree_case(G: int, width: int, seed: int):
    """G groups of `width` points; group 0 holds a doubling pair (lanes 0
    and half), an inverse pair (1 and 1 + half), an identity p (lane 2) and
    an identity q (lane 3 + half)."""
    pts = _points(G * width, seed)
    half = width // 2
    pts[half] = pts[0]
    pts[1 + half] = G1.neg(pts[1])
    pts[2] = pts[3 + half] = None
    return pts


@pytest.mark.parametrize("G,width", [(2, 8), (3, 16)])
def test_fold_add_tree_matches_chain_halo2tpu_and_g1(G, width):
    pts = _tree_case(G, width, 90 + width)
    acc = affine_to_device(pts, "cpu")
    got = cuda_ec.fold_add_tree(acc, G, width)
    assert got.shape == (G, 3, 8)
    # the chain of lanewise fold_add_any rounds it replaces
    chain, w = acc, width
    while w > 1:
        a4 = chain.reshape(G, w, 3, 8)
        chain = cuda_ec.fold_add_any(a4[:, :w // 2].reshape(-1, 3, 8),
                                     a4[:, w // 2:].reshape(-1, 3, 8))
        w //= 2
    assert torch.equal(got, chain)
    # halo2tpu: the same halving order with its jpoint.padd
    want, w = jax_affine(pts), width
    while w > 1:
        a4 = want.reshape(G, w, 3, 16)
        want = jax_padd(a4[:, :w // 2].reshape(-1, 3, 16),
                        a4[:, w // 2:].reshape(-1, 3, 16))
        w //= 2
    assert np.array_equal(convert.to_jax_limbs(got), np.asarray(want))
    sums = []
    for g in range(G):
        s = None
        for p in pts[g * width:(g + 1) * width]:
            s = G1.add(s, p)
        sums.append(s)
    assert device_to_affine(got) == sums


@pytest.mark.parametrize("G,width,lanes", [(2, 6, 12), (2, 8, 15),
                                           (0, 8, 8)])
def test_fold_add_tree_refuses_bad_groups(G, width, lanes):
    acc = affine_to_device([G1_GEN] * lanes, "cpu")
    with pytest.raises(ValueError, match="power of two"):
        cuda_ec.fold_add_tree(acc, G, width)


# -- fold_add_tree's schedule (csrc/ec_fold.cu::fold_add_tree_kernel) -------
# A slot round runs each add on cuda_ec.TREE_SLOTS threads in the steps
# below (tree_add4): their kind, "S" (fe_sqr) or "M" (fe_mul), and slot by
# slot (value, operand, operand).  X1 .. Z2 are the lanes' coordinates in
# shared memory; the adds and subtractions between steps (Z1+Z2, zw, h, hh,
# rr, ox, vx) run on every slot into registers; each product is kept in
# shared memory at TREE_KEPT's index, which later products reuse once it is
# dead (read into registers, or no longer needed).
TREE_ADD = (
    ("S0", "S", (("z1z1", "Z1", "Z1"), ("z2z2", "Z2", "Z2"),
                 ("zz", "Z1+Z2", "Z1+Z2"))),
    ("A1", "M", (("u1", "X1", "z2z2"), ("y1z2", "Y1", "Z2"),
                 ("u2", "X2", "z1z1"), ("y2z1", "Y2", "Z1"))),
    ("A2", "M", (("i", "hh", "hh"), ("s1", "y1z2", "z2z2"),
                 ("oz", "zw", "h"), ("s2", "y2z1", "z1z1"))),
    ("A3", "M", (("j", "h", "i"), ("v", "u1", "i"), ("r2", "rr", "rr"))),
    ("A4", "M", (("rvx", "rr", "vx"), ("s1j", "s1", "j"))),
)
TREE_KEPT = {"z1z1": 0, "z2z2": 1, "zz": 2, "u1": 3, "y1z2": 4, "u2": 5,
             "y2z1": 6, "i": 7, "s1": 8, "oz": 9, "s2": 10, "j": 0, "v": 1,
             "r2": 2, "rvx": 4, "s1j": 5}
# what every slot holds in registers: the lanes' coordinates it reads, the
# linear values, and the products it reads before they are reused
TREE_REGS = {"after A1": ("u1", "u2"), "after A2": ("s1", "s2")}


def _tree_add4(p, q, log: list):
    """tree_add4 in torch over every add at once: the steps on their slots,
    each kept operand read where the kernel keeps it (and checked not yet
    overwritten there), the adds and subtractions between them, and the
    identity, doubling and cancelling lanes as masks."""
    def add(a, b):
        return tjf.add(tjf.FQ, a, b)

    def sub(a, b):
        return tjf.sub(tjf.FQ, a, b)

    env = {"X1": p[:, 0], "Y1": p[:, 1], "Z1": p[:, 2], "X2": q[:, 0],
           "Y2": q[:, 1], "Z2": q[:, 2]}
    env["Z1+Z2"] = add(env["Z1"], env["Z2"])
    regs = set(env)
    kept: dict = {}

    def read(name):
        if name not in regs:
            assert kept.get(TREE_KEPT[name]) == name, f"{name} overwritten"
        return env[name]

    def hold(*names):           # values every slot reads into registers
        for name in names:
            read(name)
            regs.add(name)

    def linear(name, value):
        env[name] = value
        regs.add(name)

    after = {
        "A1": lambda: (hold(*TREE_REGS["after A1"]),
                       linear("h", sub(read("u2"), read("u1"))),
                       linear("zw", sub(sub(read("zz"), read("z1z1")),
                                        read("z2z2"))),
                       linear("hh", add(read("h"), read("h")))),
        "A2": lambda: (hold(*TREE_REGS["after A2"]),
                       linear("rr", add(*[sub(read("s2"), read("s1"))] * 2))),
        "A3": lambda: (linear("ox", sub(sub(read("r2"), read("j")),
                                        add(read("v"), read("v")))),
                       linear("vx", sub(read("v"), read("ox")))),
    }
    for name, kind, products in TREE_ADD:
        assert len(products) <= cuda_ec.TREE_SLOTS
        assert kind == "M" or all(a == b for _, a, b in products)
        done = [(out, tjf.mont_mul(tjf.FQ, read(a), read(b)))
                for out, a, b in products]
        for slot, (out, value) in enumerate(done):
            kept[TREE_KEPT[out]] = out
            env[out] = value
            log.append((name, kind, slot, out))
        if name in after:
            after[name]()
    out = torch.stack([read("ox"), sub(read("rvx"),
                                       add(read("s1j"), read("s1j"))),
                       read("oz")], dim=1)
    eq = (env["u1"] == env["u2"]).all(-1)
    same = (env["s1"] == env["s2"]).all(-1)
    ident = tjp.identity_points((p.shape[0],), "cpu")
    out = torch.where((eq & same)[:, None, None], tjp.pdbl(p), out)
    out = torch.where((eq & ~same)[:, None, None], ident, out)
    out = torch.where((q[:, 2] == 0).all(-1)[:, None, None], p, out)
    return torch.where((p[:, 2] == 0).all(-1)[:, None, None], q, out)


def _tree_schedule(acc, G: int, width: int, limit: int, log: list):
    """fold_add_tree_kernel in torch: blocks of TREE_LANES lanes, each
    loading kernel_per_block sets of m = min(width, TREE_LANES) lanes (set
    j = lanes s + k width / m of group j // (width / m)) by the kernel's
    index math; halving rounds on four slots or one thread as
    tree_round_slots says; for width > TREE_LANES each block's sum a
    partial and the last block of a group merging the group's partials in
    the tree's later rounds.  Returns (G, 3, 8) and logs (round, slots)."""
    L = cuda_ec.TREE_LANES
    m = min(width, L)
    per_set = width // m
    sets = G * per_set
    per_block = L // m
    blocks = -(-sets // per_block)
    slots = cuda_ec.tree_round_slots(G, width, limit)
    ident = tjp.identity_points((1,), "cpu")[0]
    q = torch.arange(L)
    j = torch.arange(blocks)[:, None] * per_block + q // m    # (blocks, L)
    g = j // per_set
    lane = g * width + (j - g * per_set) + (q % m) * per_set
    valid = j < sets
    buf = torch.where(valid[..., None, None],
                      acc[torch.where(valid, lane, 0)], ident)

    def rounds(buf, m, nsets, first):
        for r, h in enumerate(m >> (k + 1) for k in range(m.bit_length()
                                                          - 1)):
            a = torch.tensor([s * m + k for s in range(nsets)
                              for k in range(h)])
            p_, q_ = buf[:, a].reshape(-1, 3, 8), buf[:, a + h].reshape(
                -1, 3, 8)
            four = slots[first + r]
            log.append((first + r, four))
            added = (_tree_add4(p_, q_, []) if four else tjp.padd(p_, q_))
            buf = buf.clone()
            buf[:, a] = added.reshape(buf.shape[0], -1, 3, 8)
        return buf

    buf = rounds(buf, m, per_block, 0)
    if per_set == 1:
        return buf[:, ::m].reshape(-1, 3, 8)[:G]
    partials = buf[:, 0].reshape(G, per_set, 3, 8)            # block = set
    out = rounds(partials, per_set, 1, m.bit_length() - 1)
    return out[:, 0]


def _tree_points(G: int, width: int, seed: int):
    """G x width random Jacobian points (coordinates < 2^252: the formulas
    do not need points on the curve).  Group 0: a doubling pair (lanes 0
    and half), a cancelling pair (1 and 1 + half), an identity p (lane 2)
    and an identity q (3 + half); group 1 every lane equal (every round
    doubles); group 2 each lane i + half the negative of lane i (the first
    round cancels, the rest add identities)."""
    w = np.random.default_rng(seed).integers(0, 1 << 32, (G * width, 3, 8),
                                             dtype=np.uint32)
    w[..., 7] &= 0x0FFFFFFF
    acc = torch.from_numpy(w.view(np.int32))
    half = width // 2
    if width >= 8:
        acc[half] = acc[0]
        acc[1 + half] = acc[1]
        acc[1 + half, 1] = tjf.neg(tjf.FQ, acc[1, 1])
        acc[2, 2] = 0
        acc[3 + half, 2] = 0
    if G >= 3:
        acc[width:2 * width] = acc[width]
        g2 = acc[2 * width:3 * width]
        g2[half:] = g2[:half]
        g2[half:, 1] = tjf.neg(tjf.FQ, g2[:half, 1])
    return acc


def _jax_chain(acc, G: int, width: int):
    """halo2tpu's chain: pallas_ec.fold_add_any (interpret mode) a round,
    over 512-lane pieces (one shape, so one compile), limb-major."""
    from halo2tpu.ops.pallas_ec import fold_add_any
    piece = 512
    cur = convert.points_to_limb_major(acc)                 # (3, 16, L)
    ident = convert.points_to_limb_major(
        tjp.identity_points((piece,), "cpu"))
    w = width
    while w > 1:
        a4 = cur.reshape(3, 16, G, w)
        p = a4[..., :w // 2].reshape(3, 16, -1)
        q = a4[..., w // 2:].reshape(3, 16, -1)
        outs = []
        for i in range(0, p.shape[-1], piece):
            pp, qq = ident.copy(), ident.copy()
            k = min(piece, p.shape[-1] - i)
            pp[..., :k], qq[..., :k] = p[..., i:i + k], q[..., i:i + k]
            outs.append(np.asarray(fold_add_any(jnp.asarray(pp),
                                                jnp.asarray(qq)))[..., :k])
        cur = np.concatenate(outs, -1)
        w //= 2
    return cur


@pytest.mark.parametrize("G,width", [(1, 2), (1, 256), (1, 2048), (3, 4),
                                     (3, 1024), (3, 2048), (64, 2),
                                     (64, 64), (64, 1024)])
def test_fold_add_tree_schedule_matches_plain_and_halo2tpu(G, width):
    """The tree kernel's schedule at a wave's slot limit (67,584 threads:
    every round of these tails on four slots but 64 x 1024's first) and at
    64 threads (the wide rounds on one thread each), against
    fold_add_tree_plain and halo2tpu's fold_add_any chain, bitwise."""
    acc = _tree_points(G, width, 130 + G + width)
    want = cuda_ec.fold_add_tree_plain(acc, G, width)
    for limit in (132 * 4 * 128, 64):
        log: list = []
        got = _tree_schedule(acc, G, width, limit, log)
        assert [four for _, four in log] == cuda_ec.tree_round_slots(
            G, width, limit)
        assert torch.equal(got, want), limit
    if G >= 3:       # the doubling group and the cancelling group
        assert device_to_affine(want[1:2]) == device_to_affine(
            cuda_ec.fold_dbl_any(acc[width:width + 1],
                                 width.bit_length() - 1))
        assert (want[2, 2] == 0).all()
    jax_want = _jax_chain(acc, G, width)
    assert np.array_equal(convert.points_to_limb_major(want), jax_want)


def test_tree_round_slots_switch_at_a_wave():
    """A round runs on four slots when its adds, four threads each, fit in
    one wave of 67,584 threads: the warm proof's tails switch after one
    (96 x 1024: two) one-thread rounds; msm()'s 2032 x 64 after two."""
    wave = 132 * 4 * 128
    rule = cuda_ec.tree_round_slots
    assert rule(256, 256, wave) == [False] + [True] * 7
    assert rule(64, 1024, wave) == [False] + [True] * 9
    assert rule(32, 2048, wave) == [False] + [True] * 10
    assert rule(96, 1024, wave) == [False] * 2 + [True] * 8
    assert rule(2032, 64, wave) == [False] * 2 + [True] * 4
    assert rule(1, 2, wave) == [True]


def _partials(B: int, planes: int, seed: int):
    """(B, planes, 3, 8) Jacobian partials (doubled points, Z != 1); lane 0
    has identity planes at the top and every third plane, lane 1 none."""
    pts = _points(B * planes, seed)
    for d in range(0, planes, 3):
        pts[d] = None
    pts[planes - 1] = pts[planes - 2] = None
    jac = cuda_ec.fold_dbl_any(affine_to_device(pts, "cpu"))
    return jac.reshape(B, planes, 3, 8)


@pytest.mark.parametrize("times,planes", [(8, tmsm.NUM_WINDOWS),
                                          (1, tmsm.SCALAR_BITS)])
def test_fold_horner_matches_chain_halo2tpu_and_g1(times, planes):
    parts = _partials(2, planes, 95 + times)
    got = cuda_ec.fold_horner(parts, times)
    assert got.shape == (2, 3, 8)
    # the chain it replaces: a fold_dbl_any(times) and a fold_add_any a plane
    chain = tmsm.identity_points((2,), "cpu")
    for d in range(planes - 1, -1, -1):
        chain = cuda_ec.fold_add_any(cuda_ec.fold_dbl_any(chain, times),
                                     parts[:, d].contiguous())
    assert torch.equal(got, chain)
    # halo2tpu's host routes of the same combine on the CPU
    jparts = jnp.asarray(convert.to_jax_limbs(parts))
    host = (jmsm._wpartials_to_affine if times == 8
            else jmsm._partials_to_affine)(jparts)
    assert device_to_affine(got) == host
    # by definition: sum of 2^(times * d) * partial[d]
    aff = device_to_affine(parts.reshape(-1, 3, 8))
    want = []
    for b in range(2):
        s = None
        for d in range(planes):
            p = aff[b * planes + d]
            if p is not None:
                s = G1.add(s, G1.scalar_mul(p, pow(2, times * d, R)))
        want.append(s)
    assert host == want
    # the module's combines take the entry
    if times == 8:
        assert device_to_affine(tmsm._horner_device_w(parts)) == host
    else:
        assert device_to_affine(tmsm._horner_device(parts)) == host


def test_fold_horner_refuses_bad_shapes():
    with pytest.raises(ValueError, match="planes"):
        cuda_ec.fold_horner(torch.zeros((2, 3, 8), dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="times"):
        cuda_ec.fold_horner(torch.zeros((2, 4, 3, 8), dtype=torch.int32), 0)


# -- fold_horner's schedule (csrc/ec_fold.cu::fold_horner_kernel) ----------
# Each step is one group_mul of the kernel: its kind, "S" (fe_sqr on every
# slot: operand pairs (a, a)) or "M" (fe_mul), and the values of a batch
# lane slot by slot (slot s = the s-th entry runs on the lane's s-th
# thread), as (value, operand, operand); every operand was computed before
# the step.  The linear steps between them are _horner_linear's.
HORNER_SLOTS = 4
HORNER_DBL = (
    ("D1", "S", (("a", "X", "X"), ("b", "Y", "Y"), ("zsq", "Z", "Z"),
                 ("z2z2", "Z2", "Z2"))),
    ("D2", "S", (("c", "b", "b"), ("xb2", "xb", "xb"), ("f", "e", "e"),
                 ("w", "Y+Z", "Y+Z"))),
    ("D3", "M", (("edx", "e", "d-x3"), ("z1z1", "z3", "z3"),
                 ("y2z1", "Y2", "z3"), ("zz", "z3+Z2", "z3+Z2"))),
)
HORNER_ADD = (
    ("A1", "M", (("u1", "X", "z2z2"), ("y1z2", "Y", "Z2"),
                 ("u2", "X2", "z1z1"), ("s2", "y2z1", "z1z1"))),
    ("A2", "M", (("i", "hh", "hh"), ("s1", "y1z2", "z2z2"),
                 ("oz", "zw", "h"))),
    ("A3", "M", (("j", "h", "i"), ("v", "u1", "i"), ("r2", "rr", "rr"))),
    ("A4", "M", (("rvx", "rr", "v-ox"), ("s1j", "s1", "j"))),
)


def _horner_linear(env: dict, step: str) -> None:
    """The adds and subtractions mod q the kernel runs after a step.
    pt_dbl's Z3 = 2 Y Z is (Y + Z)^2 - Y^2 - Z^2 here, its value."""
    def add(a, b):
        return tjf.add(tjf.FQ, a, b)

    def sub(a, b):
        return tjf.sub(tjf.FQ, a, b)

    def dbl(a):
        return add(a, a)

    v = env.get
    if step == "D1":
        env["xb"] = add(v("X"), v("b"))
        env["e"] = add(dbl(v("a")), v("a"))
        env["Y+Z"] = add(v("Y"), v("Z"))
    elif step == "D2":
        env["d"] = dbl(sub(v("xb2"), add(v("a"), v("c"))))
        env["x3"] = sub(v("f"), dbl(v("d")))
        env["c8"] = dbl(dbl(dbl(v("c"))))
        env["d-x3"] = sub(v("d"), v("x3"))
        env["z3"] = sub(sub(v("w"), v("b")), v("zsq"))
        env["z3+Z2"] = add(v("z3"), v("Z2"))
    elif step == "D3":
        env["X"], env["Y"], env["Z"] = (v("x3"), sub(v("edx"), v("c8")),
                                        v("z3"))
    elif step == "A1":
        env["zw"] = sub(sub(v("zz"), v("z1z1")), v("z2z2"))
        env["h"] = sub(v("u2"), v("u1"))
        env["hh"] = dbl(env["h"])
    elif step == "A2":
        env["rr"] = dbl(sub(v("s2"), v("s1")))
    elif step == "A3":
        env["ox"] = sub(sub(v("r2"), v("j")), dbl(v("v")))
        env["v-ox"] = sub(v("v"), env["ox"])
    elif step == "A4":
        env["X"], env["Y"], env["Z"] = (
            v("ox"), sub(v("rvx"), dbl(v("s1j"))), v("oz"))


def _horner_step(env: dict, step, log: list) -> None:
    name, kind, products = step
    assert len(products) <= HORNER_SLOTS
    assert kind == "M" or all(a == b for _, a, b in products)
    done = {}
    for slot, (out, a, b) in enumerate(products):
        assert a in env and b in env, f"{name} slot {slot}: {out} too early"
        done[out] = tjf.mont_mul(tjf.FQ, env[a], env[b])
        log.append((name, kind, slot, out))
    env.update(done)
    _horner_linear(env, name)


def _horner_schedule(parts, times: int):
    """fold_horner_kernel's steps in torch over every batch lane at once:
    per plane `times` doublings (D1-D3), then the add (A1-A4, the u1 == u2
    test after A2), each lane's branches as masks.  Returns the (B, 3, 8)
    result and the (step, kind, slot, value) log of every product."""
    B = parts.shape[0]
    acc = tjp.identity_points((B,), "cpu")
    log: list = []
    for d in range(parts.shape[1] - 1, -1, -1):
        q = parts[:, d]
        env = {"X": acc[:, 0], "Y": acc[:, 1], "Z": acc[:, 2],
               "X2": q[:, 0], "Y2": q[:, 1], "Z2": q[:, 2]}
        for _ in range(times):
            for step in HORNER_DBL:
                _horner_step(env, step, log)
        dbl = torch.stack([env["X"], env["Y"], env["Z"]], dim=1)
        for step in HORNER_ADD:
            _horner_step(env, step, log)
        added = torch.stack([env["X"], env["Y"], env["Z"]], dim=1)
        zero = (dbl[:, 2] == 0).all(dim=-1)
        q_zero = (q[:, 2] == 0).all(dim=-1)
        eq = (env["u1"] == env["u2"]).all(dim=-1)
        same = (env["s1"] == env["s2"]).all(dim=-1)
        ident = tjp.identity_points((B,), "cpu")
        out = torch.where((eq & same)[:, None, None], tjp.pdbl(dbl), added)
        out = torch.where((eq & ~same)[:, None, None], ident, out)
        out = torch.where(q_zero[:, None, None], dbl, out)
        acc = torch.where(zero[:, None, None], q, out)
    return acc, log


def _horner_case(B: int, planes: int, times: int, seed: int):
    """(B, planes, 3, 8) Jacobian partials.  Lane 0: only planes 1 and 0,
    plane 0 = 2^times * plane 1 (the add doubles); lane 1: identity planes
    at the top and every third; lane 2: plane 0 = -2^times * plane 1 (the
    add gives the identity); lanes 3-4: no identity plane."""
    pts = _points(B * planes, seed)
    for b, lane in enumerate(range(B)):
        row = pts[b * planes:(b + 1) * planes]
        if lane in (0, 2):
            p1 = row[1]
            for i in range(2, planes):
                row[i] = None
            p0 = G1.scalar_mul(p1, 1 << times)
            row[0] = p0 if lane == 0 else G1.neg(p0)
        elif lane == 1:
            for i in range(0, planes, 3):
                row[i] = None
            row[planes - 1] = row[planes - 2] = None
        pts[b * planes:(b + 1) * planes] = row
    jac = cuda_ec.fold_dbl_any(affine_to_device(pts, "cpu"))
    return jac.reshape(B, planes, 3, 8)


@pytest.mark.parametrize("B", [1, 3, 5])
@pytest.mark.parametrize("times,planes", [(8, tmsm.NUM_WINDOWS),
                                          (1, tmsm.SCALAR_BITS)])
def test_fold_horner_schedule_matches_plain_and_halo2tpu(times, planes, B):
    parts = _horner_case(B, planes, times, 120 + times + B)
    got, log = _horner_schedule(parts, times)
    # at most HORNER_SLOTS products a step, 3 steps a doubling, 4 an add
    steps = {name for name, _, _, _ in log}
    assert steps == {"D1", "D2", "D3", "A1", "A2", "A3", "A4"}
    assert max(slot for _, _, slot, _ in log) == HORNER_SLOTS - 1
    assert torch.equal(got, cuda_ec.fold_horner_plain(parts, times))
    # halo2tpu's body of _horner_device_w / _horner_device (pdbl `times`
    # times, then padd, a plane), its jpoint formulas on the same limbs
    jparts = jnp.asarray(convert.to_jax_limbs(parts))
    acc = jax_identity((B,))
    for d in range(planes - 1, -1, -1):
        for _ in range(times):
            acc = jax_pdbl(acc)
        acc = jax_padd(acc, jparts[:, d])
    assert np.array_equal(convert.to_jax_limbs(got), np.asarray(acc))
    if B == 5:     # the lanes by definition
        aff = device_to_affine(parts.reshape(-1, 3, 8))
        want = []
        for b in range(B):
            s = None
            for d in range(planes):
                p = aff[b * planes + d]
                if p is not None:
                    s = G1.add(s, G1.scalar_mul(p, pow(2, times * d, R)))
            want.append(s)
        assert device_to_affine(got) == want
        assert want[2] is None


def _rows_case(seed: int, C: int = 4, B: int = 2, rows: int = 4):
    """n = rows * C bases (base 3 the identity), B scalar vectors, and acc
    lanes of every kind at their first set row: equal, inverse, identity."""
    n = rows * C
    rng = np.random.default_rng(seed)
    pts = _points(n, seed)
    pts[3] = None
    svs = [[int.from_bytes(rng.bytes(32), "big") % R for _ in range(n)]
           for _ in range(B)]
    L = tmsm.SCALAR_BITS * B * C
    accs = _points(16, seed + 1)
    accs = [accs[i % 16] for i in range(L)]
    kinds = 0
    for lane in range(L):
        g, c = divmod(lane, C)
        bit, b = divmod(g, B)
        first = next((r for r in range(rows)
                      if svs[b][r * C + c] >> bit & 1), None)
        if first is None or pts[first * C + c] is None or lane % 5:
            continue
        base = pts[first * C + c]
        accs[lane] = [base, G1.neg(base), None][kinds % 3]
        kinds += 1
    assert kinds >= 30
    return pts, svs, accs


def test_fold_mixed_tiled_rows_matches_chain_and_g1():
    C, B, rows = 4, 2, 4
    pts, svs, accs = _rows_case(97, C, B, rows)
    points = affine_to_device(pts, "cpu")
    limbs = torch.from_numpy(np.stack([ints_to_limbs(s) for s in svs]))
    acc = affine_to_device(accs, "cpu")
    got = cuda_ec.fold_mixed_tiled_rows(acc, points, limbs, C, 0, rows)
    # the chain it replaces: a fold_mixed_tiled step a row with its masks
    chain = acc
    for r in range(rows):
        chain = cuda_ec.fold_mixed_tiled(
            chain, points[r * C:(r + 1) * C],
            tmsm._bit_masks(limbs[:, r * C:(r + 1) * C]))
    assert torch.equal(got, chain)
    # a row range: rows [1, 3) after rows [0, 1), then [3, 4)
    part = cuda_ec.fold_mixed_tiled_rows(acc, points, limbs, C, 0, 1)
    part = cuda_ec.fold_mixed_tiled_rows(part, points, limbs, C, 1, 3)
    part = cuda_ec.fold_mixed_tiled_rows(part, points, limbs, C, 3, rows)
    assert torch.equal(part, got)
    want = []
    for lane, a in enumerate(accs):
        g, c = divmod(lane, C)
        bit, b = divmod(g, B)
        for r in range(rows):
            if svs[b][r * C + c] >> bit & 1:
                a = G1.add(a, pts[r * C + c])
        want.append(a)
    assert device_to_affine(got) == want


@pytest.mark.parametrize("lanes,C,n_scalars,r0,r1,match", [
    (2 * 2 * 4, 3, 16, 0, 1, "nbits"),            # C does not divide n
    (2 * 2 * 4 + 1, 4, 16, 0, 1, "nbits"),        # L not nbits * B * C
    (257 * 2 * 4, 4, 16, 0, 1, "nbits"),          # more than 256 bits
    (2 * 2 * 4, 4, 8, 0, 1, "do not match"),      # scalars of other bases
    (2 * 2 * 4, 4, 16, 2, 5, "outside"),          # rows past the end
])
def test_fold_mixed_tiled_rows_refuses_bad_shapes(lanes, C, n_scalars, r0,
                                                  r1, match):
    acc = affine_to_device([G1_GEN] * lanes, "cpu")
    points = affine_to_device([G1_GEN] * 16, "cpu")
    limbs = torch.zeros((2, n_scalars, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        cuda_ec.fold_mixed_tiled_rows(acc, points, limbs, C, r0, r1)
