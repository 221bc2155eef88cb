// Kernels 2-4: BN254 G1 point folds in Jacobian coordinates over Fq.
//
// Points are (L, 3, 8) uint32: coordinates X, Y, Z (Montgomery form), Z = 0
// for the identity.  The lane rules and formulas are those of the Pallas
// kernels they replace, so every output coordinate is bit-identical:
//   fold_mixed    <- halo2tpu/ops/pallas_ec.py::fold_mixed (_mixed_kernel ->
//                    _padd_mixed_core + _pdbl_lm doubling patch), with the
//                    MSM row loop of ops/msm.py::_partials_fused moved inside
//                    the kernel and its one-hot MXU table select replaced by
//                    a direct gather table[digit, base];
//   fold_mixed_tiled <- pallas_ec.py::_fold_mixed_tiled / fold_mixed_tiled
//                    (_mixed_tiled_kernel): one row step of the bit-serial
//                    MSM (ops/msm.py::_pallas_row_step); lane l adds base
//                    l mod C of a small (C, 3, 8) array where its mask byte
//                    is set, the same madd-2007-bl body and doubling patch;
//   fold_mixed_tiled_rows <- the row loop of ops/msm.py::_bit_partials_pallas
//                    (one _pallas_row_step, i.e. one _mixed_tiled_kernel
//                    launch, a row) in one launch: lane (bit * B + b) * C + c
//                    walks only the rows where that bit of its scalar is set
//                    and reads the bit itself, so no mask is built;
//   fold_add_any  <- pallas_ec.py::fold_add_any (_add_kernel -> _padd_core);
//                    the same entry serves pallas_ec.py::fold_add, whose
//                    L % 512 == 0 rule the Python wrapper checks;
//   fold_add_tree <- the MSM tails' chains of fold_add_any launches
//                    (ops/msm.py, _partials_fused and _bit_partials_pallas,
//                    pallas_ec.py::_fold_add_tile a round): every halving
//                    round of a tail up to 65,536 lanes wide in one launch;
//   fold_horner   <- ops/msm.py::_horner_device_w / _horner_device (XLA
//                    fori_loops of pdbl and padd): the whole Horner combine
//                    of a batch lane in one launch, four threads a lane;
//   fold_dbl_any  <- pallas_ec.py::fold_dbl_any (_dbl_kernel -> _pdbl_lm).
//
// Bound on the H100: 32-bit integer multiply throughput, like mont_mul (a
// mixed add is 7 Montgomery products and 4 squarings, a full add 11 and 5, a
// doubling 2 and 5; field.cuh's fe_sqr takes the 36 distinct limb products
// of a*a instead of 64, and its fe_mul is one out-of-line copy a kernel, so
// the point formulas' code stays small).  Each thread keeps one accumulator
// in registers.
// fold_mixed walks its rows with the accumulator in registers (read and
// written once per launch), is bounded to 128 registers a thread so that 4
// blocks of 128 fit an SM (65,536 lanes, the width ops/msm.py gives every
// full launch, are 512 blocks: one wave on 132 SMs), and gathers row r+1's
// table entry into a two-stage shared-memory ring with cp.async (and row
// r+2's digit into a register) while row r's add runs.  fold_dbl_any runs
// `times` doublings in registers per launch (the MSM's Horner step doubles
// 8 times between adds) under the same register bound.  Masked and
// identity lanes branch around the work.
// fold_mixed_tiled is one row per launch, as the Pallas kernel is: it reads
// and writes its accumulator once per row, and its C shared bases (24 KB at
// C = 256) stay in L1 instead of being broadcast to every lane in memory.
// fold_mixed_tiled_rows runs all rows in one launch under the same register
// bound as fold_mixed, the accumulator in registers.  Random scalar bits
// mask half of each warp's lanes on every row, so a row-by-row walk pays a
// full mixed add on nearly every row; here each lane builds the mask of 32
// rows from its scalar words and steps through its set rows only (__ffs),
// so a warp runs as many adds as its busiest lane has set bits (about 76 of
// 128 rows at random bits), in ascending row order as the chain did.  The
// next set row is known one step ahead: its base is gathered into the same
// two-stage cp.async ring as fold_mixed's.
// The add kernel fits 128 registers (4 blocks an SM, 67,584 lanes a wave
// on 132 SMs) without spills because pt_add takes its Z3 factor before the
// doubling test and keeps the doubling out of line; it states only its
// block size: held to 4 blocks an SM as well, ptxas chose 122 registers and
// a schedule 4% slower.  The Horner and tree kernels are held to 128
// registers and fit without spills by keeping values in shared memory
// (the Horner add's early values and acc; the tree's slot products, and
// its one-thread add reads each coordinate where it is needed).
// The MSM tails and the Horner combines are bound by latency and launches:
// their rounds have fewer lanes than a wave, and each round was a launch.
// fold_add_tree loads 256 lanes a block into shared memory and runs the
// rounds there, one barrier a round, the adds of a round packed onto the
// lowest threads so that deep rounds of several small groups still fill
// warps.  A round too narrow to fill the card (its adds on four threads
// each fit one wave) runs each add on four threads, fold_horner's step
// schedule of pt_add: a squaring and four products deep instead of
// sixteen; a group wider than 256 lanes is summed by its blocks and then
// by the last of them to finish, so a tail of width <= 65,536 is one
// launch.
// fold_horner gives each batch lane four threads that keep its accumulator
// for all planes: a chain of 256 doublings and 32 adds (or 254 and 254)
// that launches once instead of twice a plane, latency-bound (a proof's
// 1-392 lanes are under 50 warps).  A step's independent squarings or
// products run one a thread, each inlined (fe_mul_inline), and come back
// by warp shuffles, so a doubling waits for 2 squarings and a product, an
// add for 4 products, as the formulas' critical paths allow.
#include "field.cuh"

namespace {

struct Pt {
  Fe x, y, z;
};

__device__ __forceinline__ Pt pt_load(const uint32_t* ptr) {
  Pt p;
  p.x = fe_load(ptr);
  p.y = fe_load(ptr + H2_LIMBS);
  p.z = fe_load(ptr + 2 * H2_LIMBS);
  return p;
}

__device__ __forceinline__ void pt_store(uint32_t* ptr, const Pt& p) {
  fe_store(ptr, p.x);
  fe_store(ptr + H2_LIMBS, p.y);
  fe_store(ptr + 2 * H2_LIMBS, p.z);
}

__device__ __forceinline__ Pt pt_identity(const Modulus& M) {
  Pt p;
  p.x = fe_const(M.one);
  p.y = fe_const(M.one);
  p.z = fe_zero();
  return p;
}

// Jacobian doubling, identity-safe (pallas_ec.py::_pdbl_lm).
__device__ __forceinline__ Pt pt_dbl(const Pt& p, const Modulus& M) {
  const Fe a = fe_sqr(p.x, M);
  const Fe b = fe_sqr(p.y, M);
  Pt r;
  r.z = fe_mul(fe_dbl(p.y, M), p.z, M);
  const Fe xb = fe_add(p.x, b, M);
  const Fe c = fe_sqr(b, M);
  const Fe xb2 = fe_sqr(xb, M);
  const Fe d = fe_dbl(fe_sub(xb2, fe_add(a, c, M), M), M);
  const Fe e = fe_add(fe_dbl(a, M), a, M);
  const Fe f = fe_sqr(e, M);
  r.x = fe_sub(f, fe_dbl(d, M), M);
  const Fe c8 = fe_dbl(fe_dbl(fe_dbl(c, M), M), M);
  const Fe edx = fe_mul(e, fe_sub(d, r.x, M), M);
  r.y = fe_sub(edx, c8, M);
  return r;
}

// pt_dbl out of line, for the rare doubling lanes of the adds: inlined
// there it pushed pt_add's kernels and fold_mixed_tiled_rows past their
// register bound.
static __device__ __noinline__ Pt pt_dbl_call(const Pt p, const Modulus& M) {
  return pt_dbl(p, M);
}

// acc + (x2, y2) for a lane whose point is valid (pallas_ec.py::
// _padd_mixed_core, madd-2007-bl, with the doubling lanes patched).
__device__ __forceinline__ Pt pt_add_mixed(const Pt& acc, const Fe& x2,
                                           const Fe& y2, const Modulus& M) {
  if (fe_is_zero(acc.z)) {
    Pt r;
    r.x = x2;
    r.y = y2;
    r.z = fe_const(M.one);
    return r;
  }
  const Fe z1z1 = fe_sqr(acc.z, M);
  const Fe t0 = fe_mul(y2, acc.z, M);
  const Fe u2 = fe_mul(x2, z1z1, M);
  const Fe s2 = fe_mul(t0, z1z1, M);
  const Fe h = fe_sub(u2, acc.x, M);
  const Fe s2y1 = fe_sub(s2, acc.y, M);
  if (fe_is_zero(h)) {
    // acc == P doubles (a silent Z3 = 0 would corrupt the fold);
    // acc == -P gives the identity
    if (!fe_is_zero(s2y1)) return pt_identity(M);
    return pt_dbl_call(acc, M);
  }
  const Fe r = fe_dbl(s2y1, M);
  const Fe zh = fe_add(acc.z, h, M);
  const Fe hh = fe_sqr(h, M);
  const Fe rr = fe_sqr(r, M);
  const Fe zh2 = fe_sqr(zh, M);
  const Fe i = fe_dbl(fe_dbl(hh, M), M);
  const Fe j = fe_mul(h, i, M);
  const Fe v = fe_mul(acc.x, i, M);
  Pt o;
  o.x = fe_sub(fe_sub(rr, j, M), fe_dbl(v, M), M);
  const Fe y3a = fe_mul(r, fe_sub(v, o.x, M), M);
  const Fe y3b = fe_mul(acc.y, j, M);
  o.y = fe_sub(y3a, fe_dbl(y3b, M), M);
  o.z = fe_sub(fe_sub(zh2, z1z1, M), hh, M);
  return o;
}

// Full Jacobian add with identity, inverse and doubling lanes
// (pallas_ec.py::_padd_core + doubling patch).  If both are the identity
// the result is q, as in the reference's select order.
__device__ __forceinline__ Pt pt_add(const Pt& p, const Pt& q,
                                     const Modulus& M) {
  if (fe_is_zero(p.z)) return q;
  if (fe_is_zero(q.z)) return p;
  const Fe z1z1 = fe_sqr(p.z, M);
  const Fe z2z2 = fe_sqr(q.z, M);
  const Fe u1 = fe_mul(p.x, z2z2, M);
  const Fe u2 = fe_mul(q.x, z1z1, M);
  const Fe s1 = fe_mul(fe_mul(p.y, q.z, M), z2z2, M);
  const Fe s2 = fe_mul(fe_mul(q.y, p.z, M), z1z1, M);
  // (Z1 + Z2)^2 - Z1Z1 - Z2Z2 before the test, so that Z1Z1, Z2Z2 and Z2
  // die here (wasted on the rare doubling and inverse lanes)
  const Fe zw = fe_sub(fe_sub(fe_sqr(fe_add(p.z, q.z, M), M), z1z1, M),
                       z2z2, M);
  if (fe_eq(u1, u2)) {
    return fe_eq(s1, s2) ? pt_dbl_call(p, M) : pt_identity(M);
  }
  const Fe h = fe_sub(u2, u1, M);
  const Fe hh = fe_dbl(h, M);
  const Fe rr = fe_dbl(fe_sub(s2, s1, M), M);
  const Fe i = fe_sqr(hh, M);
  const Fe r2 = fe_sqr(rr, M);
  const Fe j = fe_mul(h, i, M);
  const Fe v = fe_mul(u1, i, M);
  Pt o;
  o.x = fe_sub(fe_sub(r2, j, M), fe_dbl(v, M), M);
  const Fe rvx = fe_mul(rr, fe_sub(v, o.x, M), M);
  const Fe s1j = fe_mul(s1, j, M);
  o.z = fe_mul(zw, h, M);
  o.y = fe_sub(rvx, fe_dbl(s1j, M), M);
  return o;
}

constexpr int kThreads = 128;
// Blocks of kThreads an SM must hold: caps fold_mixed, fold_dbl_any and
// fold_mixed_tiled_rows at 65,536 / (4 * 128) = 128 registers a thread.
constexpr int kMinBlocks = 4;
constexpr int kEntryChunks = 3 * H2_LIMBS / 4;   // 16-byte pieces of a point
constexpr int kTreeLanes = 2 * kThreads;         // lanes a tree block sums

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// A point in shared memory as kEntryChunks 16-byte chunks, chunk k of point
// i at buf[k * stride + i] (neighbouring points on neighbouring banks).
__device__ __forceinline__ void fe_put(uint4* buf, int stride, int i,
                                       const Fe& a) {
  buf[i] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  buf[stride + i] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
}

__device__ __forceinline__ Fe fe_get(const uint4* buf, int stride, int i) {
  const uint4 lo = buf[i];
  const uint4 hi = buf[stride + i];
  Fe r;
  r.v[0] = lo.x; r.v[1] = lo.y; r.v[2] = lo.z; r.v[3] = lo.w;
  r.v[4] = hi.x; r.v[5] = hi.y; r.v[6] = hi.z; r.v[7] = hi.w;
  return r;
}

__device__ __forceinline__ void pt_put(uint4* buf, int stride, int i,
                                       const Pt& p) {
  fe_put(buf, stride, i, p.x);
  fe_put(buf + 2 * stride, stride, i, p.y);
  fe_put(buf + 4 * stride, stride, i, p.z);
}

__device__ __forceinline__ Pt pt_get(const uint4* buf, int stride, int i) {
  Pt p;
  p.x = fe_get(buf, stride, i);
  p.y = fe_get(buf + 2 * stride, stride, i);
  p.z = fe_get(buf + 4 * stride, stride, i);
  return p;
}

// Lane l = g * C + c, g = plane * B + b.  For rows r in [r0, r1) the lane
// adds table[digit, r * C + c], digit = byte `plane` of scalar b at that
// base.  Table entries with Z = 0 (digit 0, padded bases) leave acc as is.
// Stage s of the ring holds each thread's 96-byte entry as 6 chunks of 16
// bytes, chunk k of thread t at ring[s][k][t] (neighbouring threads on
// neighbouring banks).  A thread reads only what it copied itself, so
// cp.async.wait_group alone orders the copy before the read; the copy into
// a stage is issued after the instructions that used its previous contents.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fold_mixed_kernel(const uint32_t* __restrict__ acc_in,
                  uint32_t* __restrict__ acc_out,
                  const uint32_t* __restrict__ table,
                  const uint32_t* __restrict__ scalars, long long lanes,
                  int C, int B, long long npad, int r0, int r1,
                  const __grid_constant__ Modulus M) {
  __shared__ uint4 ring[2][kEntryChunks][kThreads];
  const int t = threadIdx.x;
  const long long l = blockIdx.x * (long long)kThreads + t;
  if (l >= lanes) return;
  const long long g = l / C;
  const int c = (int)(l - g * C);
  const int plane = (int)(g / B);
  const int b = (int)(g - (long long)plane * B);
  const int shift = (plane & 3) * 8;
  const uint32_t* sc =
      scalars + (long long)b * npad * H2_LIMBS + (plane >> 2) + c * H2_LIMBS;
  const long long row_words = (long long)C * H2_LIMBS;
  auto digit = [&](int r) -> uint32_t {
    return (__ldg(sc + r * row_words) >> shift) & 0xFFu;
  };
  auto fetch = [&](int r, uint32_t d, int s) {
    const uint4* e = reinterpret_cast<const uint4*>(
        table + (d * npad + (long long)r * C + c) * 3 * H2_LIMBS);
#pragma unroll
    for (int k = 0; k < kEntryChunks; k++) cp_async16(&ring[s][k][t], e + k);
    cp_async_commit();
  };
  Pt acc = pt_load(acc_in + l * 3 * H2_LIMBS);
  if (r0 < r1) fetch(r0, digit(r0), 0);
  uint32_t next = r0 + 1 < r1 ? digit(r0 + 1) : 0;
  for (int r = r0; r < r1; r++) {
    const int s = (r - r0) & 1;
    if (r + 1 < r1) {
      fetch(r + 1, next, s ^ 1);
      if (r + 2 < r1) next = digit(r + 2);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    uint32_t e[3 * H2_LIMBS];
#pragma unroll
    for (int k = 0; k < kEntryChunks; k++) {
      const uint4 v = ring[s][k][t];
      e[4 * k] = v.x; e[4 * k + 1] = v.y; e[4 * k + 2] = v.z;
      e[4 * k + 3] = v.w;
    }
    Fe x2, y2, z2;
#pragma unroll
    for (int i = 0; i < H2_LIMBS; i++) {
      x2.v[i] = e[i];
      y2.v[i] = e[H2_LIMBS + i];
      z2.v[i] = e[2 * H2_LIMBS + i];
    }
    if (fe_is_zero(z2)) continue;
    acc = pt_add_mixed(acc, x2, y2, M);
  }
  pt_store(acc_out + l * 3 * H2_LIMBS, acc);
}

// Lane l adds pts_c[l mod C] where bits[l] != 0 (the Pallas tiled kernel's
// mask).  Bases with Z = 0 leave acc as is.
__global__ void fold_mixed_tiled_kernel(const uint32_t* __restrict__ acc_in,
                                        uint32_t* __restrict__ acc_out,
                                        const uint32_t* __restrict__ pts_c,
                                        const uint8_t* __restrict__ bits,
                                        long long lanes, int C,
                                        const __grid_constant__ Modulus M) {
  const long long l = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  Pt acc = pt_load(acc_in + l * 3 * H2_LIMBS);
  if (bits[l] != 0) {
    const uint32_t* e = pts_c + (l % C) * 3 * H2_LIMBS;
    const Fe z2 = fe_load(e + 2 * H2_LIMBS);
    if (!fe_is_zero(z2)) {
      acc = pt_add_mixed(acc, fe_load(e), fe_load(e + H2_LIMBS), M);
    }
  }
  pt_store(acc_out + l * 3 * H2_LIMBS, acc);
}

// Rows r in [r0, r1) of the bit-serial MSM: lane l = (bit * B + b) * C + c
// adds points[r * C + c] where bit `bit` of scalars[b, r * C + c] is set
// (scalars (B, n, 8) plain limbs); bases with Z = 0 leave acc as is.  Each
// lane takes its set rows in ascending order, 32 rows of mask at a time.
// The ring is fold_mixed's: a thread reads only the stage it copied into.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fold_mixed_tiled_rows_kernel(const uint32_t* __restrict__ acc_in,
                             uint32_t* __restrict__ acc_out,
                             const uint32_t* __restrict__ points,
                             const uint32_t* __restrict__ scalars,
                             long long lanes, int C, int B, long long n,
                             int r0, int r1,
                             const __grid_constant__ Modulus M) {
  __shared__ uint4 ring[2][kEntryChunks][kThreads];
  const int t = threadIdx.x;
  const long long l = blockIdx.x * (long long)kThreads + t;
  if (l >= lanes) return;
  const long long g = l / C;
  const int c = (int)(l - g * C);
  const int bit = (int)(g / B);
  const int b = (int)(g - (long long)bit * B);
  const int shift = bit & 31;
  const uint32_t* sc =
      scalars + ((long long)b * n + c) * H2_LIMBS + (bit >> 5);
  const long long row_words = (long long)C * H2_LIMBS;
  int chunk = r0 - 32;   // first row of the chunk that `mask` covers
  uint32_t mask = 0;     // its rows not taken yet whose bit is set
  auto next_row = [&]() -> int {
    while (mask == 0) {
      chunk += 32;
      if (chunk >= r1) return -1;
#pragma unroll 8   // fully unrolled, the 32 loads in flight spilled
      for (int i = 0; i < 32; i++) {
        if (chunk + i < r1) {
          mask |= ((__ldg(sc + (chunk + i) * row_words) >> shift) & 1u) << i;
        }
      }
    }
    const int i = __ffs(mask) - 1;
    mask &= mask - 1;
    return chunk + i;
  };
  auto fetch = [&](int r, int s) {
    const uint4* e = reinterpret_cast<const uint4*>(
        points + ((long long)r * C + c) * 3 * H2_LIMBS);
#pragma unroll
    for (int k = 0; k < kEntryChunks; k++) cp_async16(&ring[s][k][t], e + k);
    cp_async_commit();
  };
  Pt acc = pt_load(acc_in + l * 3 * H2_LIMBS);
  int r = next_row();
  if (r >= 0) fetch(r, 0);
  for (int s = 0; r >= 0; s ^= 1) {
    const int next = next_row();
    if (next >= 0) {
      fetch(next, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const Pt e = pt_get(&ring[s][0][0], kThreads, t);
    if (!fe_is_zero(e.z)) acc = pt_add_mixed(acc, e.x, e.y, M);
    r = next;
  }
  pt_store(acc_out + l * 3 * H2_LIMBS, acc);
}

__global__ void __launch_bounds__(kThreads)
fold_add_kernel(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
                uint32_t* __restrict__ out, long long lanes,
                const __grid_constant__ Modulus M) {
  const long long l = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const Pt a = pt_load(p + l * 3 * H2_LIMBS);
  const Pt b = pt_load(q + l * 3 * H2_LIMBS);
  pt_store(out + l * 3 * H2_LIMBS, pt_add(a, b, M));
}

// fold_add_tree: the rounds of a tail whose adds, four threads each, fit
// in one wave of the card (slot_limit threads) run each add on four threads
// (tree_add4, the step schedule of fold_horner's add); wider rounds run one
// add a thread (tree_add1, pt_add).  The products one add of a slot round
// keeps in shared memory (its threads read them from there: no shuffle),
// those of steps S0-A2, then from A3 on the dead ones reused.
enum {
  kTZ1Z1, kTZ2Z2, kTZZ, kTU1, kTY1Z2, kTU2, kTY2Z1, kTI, kTS1, kTOZ, kTS2,
  kTKept,
  kTJ = kTZ1Z1, kTV = kTZ2Z2, kTR2 = kTZZ, kTRVX = kTY1Z2, kTS1J = kTU2
};
constexpr int kTreeSlots = 4;
constexpr int kTreeAdds = kThreads / kTreeSlots;   // adds a pass of a round

__device__ __forceinline__ Fe fe_sel4(int s, const Fe& a0, const Fe& a1,
                                      const Fe& a2, const Fe& a3) {
  Fe r;
#pragma unroll
  for (int i = 0; i < H2_LIMBS; i++)
    r.v[i] = s == 0 ? a0.v[i] : s == 1 ? a1.v[i] : s == 2 ? a2.v[i] : a3.v[i];
  return r;
}

__device__ __forceinline__ Fe fe_load_cg(const uint32_t* ptr) {
  const uint4 lo = __ldcg(reinterpret_cast<const uint4*>(ptr));
  const uint4 hi = __ldcg(reinterpret_cast<const uint4*>(ptr + 4));
  Fe r;
  r.v[0] = lo.x; r.v[1] = lo.y; r.v[2] = lo.z; r.v[3] = lo.w;
  r.v[4] = hi.x; r.v[5] = hi.y; r.v[6] = hi.z; r.v[7] = hi.w;
  return r;
}

// buf lane a <- lane a + lane b on one thread: pt_add's steps, each
// coordinate read from shared memory only where it is needed (the held
// points pushed pt_add past 128 registers beside tree_add4)
__device__ __forceinline__ void tree_add1(uint4* buf, int a, int b,
                                          const Modulus& M) {
  auto lane = [&](int coord, int i) {
    return fe_get(buf + 2 * coord * kTreeLanes, kTreeLanes, i);
  };
  const Fe z1 = lane(2, a), z2 = lane(2, b);
  if (fe_is_zero(z1)) {
    pt_put(buf, kTreeLanes, a, pt_get(buf, kTreeLanes, b));
    return;
  }
  if (fe_is_zero(z2)) return;
  const Fe z1z1 = fe_sqr(z1, M);
  const Fe z2z2 = fe_sqr(z2, M);
  const Fe u1 = fe_mul(lane(0, a), z2z2, M);
  const Fe u2 = fe_mul(lane(0, b), z1z1, M);
  const Fe s1 = fe_mul(fe_mul(lane(1, a), z2, M), z2z2, M);
  const Fe s2 = fe_mul(fe_mul(lane(1, b), z1, M), z1z1, M);
  const Fe zw = fe_sub(fe_sub(fe_sqr(fe_add(z1, z2, M), M), z1z1, M),
                       z2z2, M);
  if (fe_eq(u1, u2)) {
    pt_put(buf, kTreeLanes, a,
           fe_eq(s1, s2) ? pt_dbl_call(pt_get(buf, kTreeLanes, a), M)
                         : pt_identity(M));
    return;
  }
  const Fe h = fe_sub(u2, u1, M);
  const Fe rr = fe_dbl(fe_sub(s2, s1, M), M);
  const Fe i = fe_sqr(fe_dbl(h, M), M);
  const Fe j = fe_mul(h, i, M);
  const Fe v = fe_mul(u1, i, M);
  Pt o;
  o.x = fe_sub(fe_sub(fe_sqr(rr, M), j, M), fe_dbl(v, M), M);
  const Fe rvx = fe_mul(rr, fe_sub(v, o.x, M), M);
  const Fe s1j = fe_mul(s1, j, M);
  o.z = fe_mul(zw, h, M);
  o.y = fe_sub(rvx, fe_dbl(s1j, M), M);
  pt_put(buf, kTreeLanes, a, o);
}

// buf lane a <- lane a + lane b (pt_add, the same values) on the four
// threads slot 0-3 of add L, in steps of at most four independent
// squarings (S) or products (M), one a slot, each stored to kept:
//   S0 S  Z1Z1 = Z1^2, Z2Z2 = Z2^2, ZZ = (Z1 + Z2)^2
//   A1 M  U1 = X1 Z2Z2, Y1 Z2, U2 = X2 Z1Z1, Y2 Z1
//   A2 M  I = (2H)(2H), S1 = Y1Z2 Z2Z2, Z3 = ZW H, S2 = Y2Z1 Z1Z1
//         (ZW = ZZ - Z1Z1 - Z2Z2, H = U2 - U1; then the U1 == U2 test)
//   A3 M  J = H I, V = U1 I, R R          (R = 2 (S2 - S1))
//   A4 M  R (V - X3), S1 J                (X3 = R R - J - 2 V)
// The adds and subtractions between steps run on every slot (the same
// values, no divergence).  The critical path is a squaring and four
// products; pt_add's squarings of 2H and R are products here (the same
// canonical values, so the same bits).  Every branch depends on values all
// four threads hold, so they stay together.
__device__ __forceinline__ void tree_add4(uint4* buf, uint4* kept, int L,
                                          int slot, unsigned mask, int a,
                                          int b, const Modulus& M) {
  auto lane = [&](int coord, int i) {
    return fe_get(buf + 2 * coord * kTreeLanes, kTreeLanes, i);
  };
  auto get = [&](int v) { return fe_get(kept + 2 * v * kTreeAdds, kTreeAdds, L); };
  auto keep = [&](int v, const Fe& x) {
    fe_put(kept + 2 * v * kTreeAdds, kTreeAdds, L, x);
  };
  const Fe z1 = lane(2, a), z2 = lane(2, b);
  if (fe_is_zero(z1)) {                 // p the identity: the sum is q
    if (slot < 3)
      fe_put(buf + 2 * slot * kTreeLanes, kTreeLanes, a, lane(slot, b));
  } else if (!fe_is_zero(z2)) {         // q the identity: p stays
    {
      const Fe x = fe_sel4(slot, z1, z2, fe_add(z1, z2, M), z1);
      const Fe y = fe_sqr(x, M);
      if (slot < 3) keep(kTZ1Z1 + slot, y);
    }
    __syncwarp(mask);
    {
      const Fe x = lane(slot & 1, slot < 2 ? a : b);     // X1, Y1, X2, Y2
      const Fe y = slot & 1 ? lane(2, slot == 1 ? b : a)  // Z2, Z1
                            : get(slot == 0 ? kTZ2Z2 : kTZ1Z1);
      keep(kTU1 + slot, fe_mul(x, y, M));
    }
    __syncwarp(mask);
    const Fe u1 = get(kTU1), u2 = get(kTU2);
    const Fe h = fe_sub(u2, u1, M);
    {
      const Fe z1z1 = get(kTZ1Z1), z2z2 = get(kTZ2Z2);
      const Fe zw = fe_sub(fe_sub(get(kTZZ), z1z1, M), z2z2, M);
      const Fe hh = fe_dbl(h, M);
      const Fe x = fe_sel4(slot, hh, get(kTY1Z2), zw, get(kTY2Z1));
      const Fe y = fe_sel4(slot, hh, z2z2, h, z1z1);
      keep(kTI + slot, fe_mul(x, y, M));
    }
    __syncwarp(mask);
    const Fe s1 = get(kTS1), s2 = get(kTS2);
    if (fe_eq(u1, u2)) {                // p == q doubles, p == -q cancels
      if (slot == 0) {
        const Pt p = pt_get(buf, kTreeLanes, a);
        pt_put(buf, kTreeLanes, a,
               fe_eq(s1, s2) ? pt_dbl_call(p, M) : pt_identity(M));
      }
    } else {
      const Fe rr = fe_dbl(fe_sub(s2, s1, M), M);
      {
        const Fe i = get(kTI);
        const Fe y = fe_mul(fe_sel4(slot, h, u1, rr, h),
                            slot == 2 ? rr : i, M);
        if (slot < 3) keep(kTJ + slot, y);
      }
      __syncwarp(mask);
      const Fe j = get(kTJ), v = get(kTV);
      const Fe ox = fe_sub(fe_sub(get(kTR2), j, M), fe_dbl(v, M), M);
      {
        const bool first = (slot & 1) == 0;
        const Fe y = fe_mul(first ? rr : s1, first ? fe_sub(v, ox, M) : j, M);
        if (slot < 2) keep(kTRVX + slot, y);
      }
      __syncwarp(mask);
      if (slot == 0) {
        Pt o;
        o.x = ox;
        o.y = fe_sub(get(kTRVX), fe_dbl(get(kTS1J), M), M);
        o.z = get(kTOZ);
        pt_put(buf, kTreeLanes, a, o);
      }
    }
  }
  __syncwarp(mask);
}

// Halving rounds over `sets` sets of m lanes packed in buf (set s at lanes
// s m .. s m + m - 1): round j adds lane k + h into lane k of each set (h =
// m / 2^(j+1)).  `round` is the tree's round of the first (global adds G
// width / 2^(round+1)); a round runs on four threads an add where those
// fit in slot_limit threads, else one thread an add (packed onto the
// lowest threads).  A thread reads and writes only its own add's lanes, so
// one barrier a round suffices.
__device__ __forceinline__ void tree_rounds(uint4* buf, uint4* kept, int m,
                                            int sets, int round,
                                            long long lanes,
                                            long long slot_limit,
                                            const Modulus& M) {
  const int t = threadIdx.x;
  for (int h = m >> 1; h > 0; h >>= 1, round++) {
    const int adds = sets * h;
    if ((lanes >> (round + 1)) * kTreeSlots > slot_limit) {
      if (t < adds) {
        const int set = t / h;
        const int a = set * m + (t - set * h);
        tree_add1(buf, a, a + h, M);
      }
    } else {
      const int L = t / kTreeSlots, slot = t % kTreeSlots;
      const unsigned mask = 0xFu << ((t % 32) & ~3);
      for (int x = L; x < adds; x += kTreeAdds) {
        const int set = x / h;
        const int a = set * m + (x - set * h);
        tree_add4(buf, kept, L, slot, mask, a, a + h, M);
      }
    }
    __syncthreads();
  }
}

// Each group of `width` lanes (a power of two <= 65,536) summed by halving
// rounds in one launch, round j adding lane i + w/2 into lane i (w the
// width before the round), as the chain of lanewise launches did.  A set
// is the m = min(width, kTreeLanes) lanes s + k * (width / m) of a group,
// which the first log2(m) rounds keep to themselves; a block takes
// kTreeLanes / m whole sets into shared memory (24 KB) and halves them.
// Width <= kTreeLanes: a set is a group, and the block writes its sums.
// Wider groups: a block a set writes its sum to partials (the group's lane
// s of width / m) and takes a ticket from the group's counter; the block
// that takes the last runs the group's remaining rounds over the partials
// (at most kTreeLanes) and zeroes the counter for the next launch.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fold_add_tree_kernel(const uint32_t* __restrict__ in,
                     uint32_t* __restrict__ out, uint32_t* partials,
                     int* counters, long long groups, int width,
                     long long slot_limit,
                     const __grid_constant__ Modulus M) {
  __shared__ uint4 lanes[kEntryChunks][kTreeLanes];
  __shared__ uint4 kept[2 * kTKept][kTreeAdds];
  __shared__ int last;
  uint4* buf = &lanes[0][0];
  uint4* kv = &kept[0][0];
  const int t = threadIdx.x;
  const int m = width < kTreeLanes ? width : kTreeLanes;
  const int per_set = width / m;               // sets a group
  const long long sets = groups * per_set;
  const int per_block = kTreeLanes / m;
  const long long j0 = (long long)blockIdx.x * per_block;
  const int mine = (int)(sets - j0 < per_block ? sets - j0 : per_block);
  for (int q = t; q < mine * m; q += kThreads) {
    const long long j = j0 + q / m;
    const long long g = j / per_set;
    const long long lane =
        g * width + (j - g * per_set) + (long long)(q % m) * per_set;
    pt_put(buf, kTreeLanes, q, pt_load(in + lane * 3 * H2_LIMBS));
  }
  __syncthreads();
  const long long all = groups * width;
  tree_rounds(buf, kv, m, mine, 0, all, slot_limit, M);
  if (per_set == 1) {
    if (t < mine)
      pt_store(out + (j0 + t) * 3 * H2_LIMBS, pt_get(buf, kTreeLanes, t * m));
    return;
  }
  const long long g = j0 / per_set;
  if (t == 0) {
    pt_store(partials + j0 * 3 * H2_LIMBS, pt_get(buf, kTreeLanes, 0));
    __threadfence();
    last = atomicAdd(counters + g, 1) == per_set - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int q = t; q < per_set; q += kThreads) {
    const uint32_t* src = partials + (g * per_set + q) * 3 * H2_LIMBS;
    Pt p;
    p.x = fe_load_cg(src);
    p.y = fe_load_cg(src + H2_LIMBS);
    p.z = fe_load_cg(src + 2 * H2_LIMBS);
    pt_put(buf, kTreeLanes, q, p);
  }
  if (t == 0) counters[g] = 0;
  __syncthreads();
  tree_rounds(buf, kv, per_set, 1, 31 - __clz(m), all, slot_limit, M);
  if (t == 0) pt_store(out + g * 3 * H2_LIMBS, pt_get(buf, kTreeLanes, 0));
}

// `times` chained doublings of each lane, in registers.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fold_dbl_kernel(const uint32_t* __restrict__ p, uint32_t* __restrict__ out,
                long long lanes, int times,
                const __grid_constant__ Modulus M) {
  const long long l = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  Pt a = pt_load(p + l * 3 * H2_LIMBS);
  for (int i = 0; i < times; i++) a = pt_dbl(a, M);
  pt_store(out + l * 3 * H2_LIMBS, a);
}

// fold_horner: kHornerSlots threads a batch lane.  Each keeps acc and the
// step's operands in registers, and the Montgomery products of a step are
// spread over the slots: slot s multiplies its operand pair (chosen by
// selects, no branch), and the slots take back by warp shuffles the
// products they all need; the add's products that the doublings make early
// wait in shared memory.  The branches (identity lanes, u1 == u2) depend
// only on values every slot of the lane holds, so a lane's slots stay
// together; each lane shuffles and syncs under its own mask.
constexpr int kHornerSlots = 4;
constexpr int kHornerThreads = 32;   // eight batch lanes a block
constexpr int kHornerLanes = kHornerThreads / kHornerSlots;
// blocks of kHornerThreads an SM must hold: at most 128 registers a thread
constexpr int kHornerBlocks = 65536 / (128 * kHornerThreads);

__device__ __forceinline__ Fe fe_shfl(const Fe& a, unsigned mask, int src) {
  Fe r;
#pragma unroll
  for (int i = 0; i < H2_LIMBS; i++) r.v[i] = __shfl_sync(mask, a.v[i], src);
  return r;
}

struct Step {
  unsigned mask;   // the lane's slots
  int lead;        // its slot 0's lane of the warp
  int slot;
};

// One step of a lane: slot s < N computes a_s * b_s (kSquare: a_s^2, b_s
// unread); the products of slots 0 .. NB-1 reach every slot (r0 .. r3),
// and each slot returns its own.  Slots from N on compute a copy of slot
// 0's.  A step is all squarings or all products, so the slots of a warp
// never diverge.
template <int N, int NB, bool kSquare = false>
__device__ __forceinline__ Fe group_mul(const Step& g, const Modulus& M,
                                        Fe& r0, Fe& r1, Fe& r2, Fe& r3,
                                        const Fe& a0, const Fe& b0,
                                        const Fe& a1, const Fe& b1,
                                        const Fe& a2, const Fe& b2,
                                        const Fe& a3, const Fe& b3) {
  const int s = g.slot < N ? g.slot : 0;
  const Fe a = fe_sel4(s, a0, a1, a2, a3);
  const Fe p = kSquare ? fe_sqr(a, M)
                       : fe_mul_inline(a, fe_sel4(s, b0, b1, b2, b3), M);
  r0 = fe_shfl(p, g.mask, g.lead);
  if (NB > 1) r1 = fe_shfl(p, g.mask, g.lead + 1);
  if (NB > 2) r2 = fe_shfl(p, g.mask, g.lead + 2);
  if (NB > 3) r3 = fe_shfl(p, g.mask, g.lead + 3);
  return p;
}

// Values kept a batch lane in shared memory: the add's values the
// doublings make, and acc for the add's rare doubling branch (so that
// neither stays in registers across the steps between)
enum { kZ2Z2, kZ1Z1, kY2Z1, kZZ, kX1, kY1, kZ1, kKept };

// Horner combine of batch lane b over partials (B, planes, 3, 8): from the
// identity, top plane down, `times` doublings (pt_dbl) then acc +
// partials[b, d] (pt_add), with pt_dbl's and pt_add's values, in steps of
// at most four independent squarings (S) or products (M) on slots 0-3 ([..]
// kept only in the first or last doubling of a plane):
//   D1 S  a = X^2, b = Y^2, Z^2, [first: Z2Z2 = Z2^2]
//   D2 S  c = b^2, (X + b)^2, f = (3a)^2, (Y + Z)^2
//   D3 M  e (d - X3), [last: Z1Z1 = Z3 Z3, Y2 Z3, (Z3 + Z2)(Z3 + Z2)]
//   A1 M  U1 = X1 Z2Z2, Y1 Z2, U2 = X2 Z1Z1, S2 = Y2Z1 Z1Z1
//   A2 M  i = (2H)(2H), S1 = Y1Z2 Z2Z2, Z3 = (..) H  (then the u1 == u2 test)
//   A3 M  j = H i, v = U1 i, r r
//   A4 M  r (v - X3), S1 j
// pt_dbl's Z3 = 2Y Z is taken as (Y + Z)^2 - Y^2 - Z^2, so that D1 and D2
// are squarings only (a squaring's latency is about 0.7 of a product's);
// every value is the canonical one pt_dbl and pt_add compute, so the bits
// are theirs.  The critical path is theirs too: 2 squarings and a product
// a doubling, 4 products an add.  tests/test_torch_ec_tree.py writes the
// schedule out in torch.
__global__ void __launch_bounds__(kHornerThreads, kHornerBlocks)
fold_horner_kernel(const uint32_t* __restrict__ partials,
                   uint32_t* __restrict__ out, int B, int planes, int times,
                   const __grid_constant__ Modulus M) {
  __shared__ uint4 kept[kKept * 2][kHornerLanes];
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) / kHornerSlots;
  if (b >= B) return;
  const int lb = threadIdx.x / kHornerSlots;
  Step g;
  g.slot = threadIdx.x % kHornerSlots;
  g.lead = (threadIdx.x % 32) - g.slot;
  g.mask = ((1u << kHornerSlots) - 1) << g.lead;
  auto keep = [&](int k, const Fe& v) {
    fe_put(&kept[2 * k][0], kHornerLanes, lb, v);
  };
  auto kept_fe = [&](int k) {
    return fe_get(&kept[2 * k][0], kHornerLanes, lb);
  };
  const uint32_t* part = partials + (long long)b * planes * 3 * H2_LIMBS;
  Pt acc = pt_identity(M);
  Fe unused;
  for (int d = planes - 1; d >= 0; d--) {
    const uint32_t* q = part + d * 3 * H2_LIMBS;
    auto z2 = [&]() { return fe_load(q + 2 * H2_LIMBS); };
    for (int i = 0; i < times; i++) {
      Fe a, bb, zsq;
      const Fe z2i = z2();
      Fe p = group_mul<4, 3, true>(g, M, a, bb, zsq, unused, acc.x, acc.x,
                                   acc.y, acc.y, acc.z, acc.z, z2i, z2i);
      if (i == 0 && g.slot == 3) keep(kZ2Z2, p);
      const Fe xb = fe_add(acc.x, bb, M);
      const Fe e = fe_add(fe_dbl(a, M), a, M);
      const Fe yz = fe_add(acc.y, acc.z, M);
      Fe c, xb2, f, w;
      group_mul<4, 4, true>(g, M, c, xb2, f, w, bb, bb, xb, xb, e, e, yz,
                            yz);
      const Fe dd = fe_dbl(fe_sub(xb2, fe_add(a, c, M), M), M);
      const Fe x3 = fe_sub(f, fe_dbl(dd, M), M);
      const Fe c8 = fe_dbl(fe_dbl(fe_dbl(c, M), M), M);
      const Fe z3 = fe_sub(fe_sub(w, bb, M), zsq, M);
      const Fe z3z2 = fe_add(z3, z2(), M);
      Fe edx;
      p = group_mul<4, 1>(g, M, edx, unused, unused, unused, e,
                          fe_sub(dd, x3, M), z3, z3, fe_load(q + H2_LIMBS),
                          z3, z3z2, z3z2);
      if (i == times - 1 && g.slot > 0) keep(kZ2Z2 + g.slot, p);
      acc.x = x3;
      acc.y = fe_sub(edx, c8, M);
      acc.z = z3;
    }
    if (fe_is_zero(acc.z)) {
      acc = pt_load(q);
      continue;
    }
    if (fe_is_zero(z2())) continue;
    if (g.slot == 0) {
      keep(kX1, acc.x);
      keep(kY1, acc.y);
      keep(kZ1, acc.z);
    }
    __syncwarp(g.mask);
    const Fe z2z2 = kept_fe(kZ2Z2), z1z1 = kept_fe(kZ1Z1);
    Fe u1, y1z2, u2, s2;
    group_mul<4, 4>(g, M, u1, y1z2, u2, s2, acc.x, z2z2, acc.y, z2(),
                    fe_load(q), z1z1, kept_fe(kY2Z1), z1z1);
    const Fe zw = fe_sub(fe_sub(kept_fe(kZZ), z1z1, M), z2z2, M);
    const Fe h = fe_sub(u2, u1, M);
    const Fe hh = fe_dbl(h, M);
    Fe ii, s1, oz;
    group_mul<3, 3>(g, M, ii, s1, oz, unused, hh, hh, y1z2, z2z2, zw, h, zw,
                    zw);
    if (fe_eq(u1, u2)) {
      Pt p1;
      p1.x = kept_fe(kX1);
      p1.y = kept_fe(kY1);
      p1.z = kept_fe(kZ1);
      acc = fe_eq(s1, s2) ? pt_dbl_call(p1, M) : pt_identity(M);
      continue;
    }
    const Fe rr = fe_dbl(fe_sub(s2, s1, M), M);
    Fe j, v, r2;
    group_mul<3, 3>(g, M, j, v, r2, unused, h, ii, u1, ii, rr, rr, rr, rr);
    const Fe ox = fe_sub(fe_sub(r2, j, M), fe_dbl(v, M), M);
    Fe rvx, s1j;
    const Fe vx = fe_sub(v, ox, M);
    group_mul<2, 2>(g, M, rvx, s1j, unused, unused, rr, vx, s1, j, rr, vx,
                    rr, vx);
    acc.x = ox;
    acc.y = fe_sub(rvx, fe_dbl(s1j, M), M);
    acc.z = oz;
  }
  if (g.slot == 0) pt_store(out + (long long)b * 3 * H2_LIMBS, acc);
}

unsigned blocks_for(long long lanes) {
  return (unsigned)((lanes + kThreads - 1) / kThreads);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError().
extern "C" int h2_fold_mixed(const void* acc_in, void* acc_out,
                             const void* table, const void* scalars,
                             long long lanes, int C, int B, long long npad,
                             int r0, int r1, const uint32_t* mod,
                             void* stream) {
  if (lanes > 0) {
    fold_mixed_kernel<<<blocks_for(lanes), kThreads, 0,
                        (cudaStream_t)stream>>>(
        (const uint32_t*)acc_in, (uint32_t*)acc_out, (const uint32_t*)table,
        (const uint32_t*)scalars, lanes, C, B, npad, r0, r1,
        modulus_from_words(mod));
  }
  return (int)cudaGetLastError();
}

extern "C" int h2_fold_mixed_tiled(const void* acc_in, void* acc_out,
                                   const void* pts_c, const void* bits,
                                   long long lanes, int C,
                                   const uint32_t* mod, void* stream) {
  if (lanes > 0) {
    fold_mixed_tiled_kernel<<<blocks_for(lanes), kThreads, 0,
                              (cudaStream_t)stream>>>(
        (const uint32_t*)acc_in, (uint32_t*)acc_out, (const uint32_t*)pts_c,
        (const uint8_t*)bits, lanes, C, modulus_from_words(mod));
  }
  return (int)cudaGetLastError();
}

extern "C" int h2_fold_mixed_tiled_rows(const void* acc_in, void* acc_out,
                                        const void* points,
                                        const void* scalars, long long lanes,
                                        int C, int B, long long n, int r0,
                                        int r1, const uint32_t* mod,
                                        void* stream) {
  if (lanes > 0) {
    fold_mixed_tiled_rows_kernel<<<blocks_for(lanes), kThreads, 0,
                                   (cudaStream_t)stream>>>(
        (const uint32_t*)acc_in, (uint32_t*)acc_out, (const uint32_t*)points,
        (const uint32_t*)scalars, lanes, C, B, n, r0, r1,
        modulus_from_words(mod));
  }
  return (int)cudaGetLastError();
}

// width a power of two in [2, kTreeLanes^2]; partials (groups * width /
// kTreeLanes, 3, 8) and counters (groups, zero) when width > kTreeLanes.
extern "C" int h2_fold_add_tree(const void* in, void* out, void* partials,
                                void* counters, long long groups, int width,
                                long long slot_limit, const uint32_t* mod,
                                void* stream) {
  if (width < 2 || (width & (width - 1)) ||
      width > kTreeLanes * kTreeLanes ||
      (width > kTreeLanes && (partials == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int m = width < kTreeLanes ? width : kTreeLanes;
  const long long sets = groups * (width / m);
  const int per_block = kTreeLanes / m;
  if (sets > 0) {
    fold_add_tree_kernel<<<(unsigned)((sets + per_block - 1) / per_block),
                           kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)in, (uint32_t*)out, (uint32_t*)partials,
        (int*)counters, groups, width, slot_limit, modulus_from_words(mod));
  }
  return (int)cudaGetLastError();
}

extern "C" int h2_fold_horner(const void* partials, void* out, int B,
                              int planes, int times, const uint32_t* mod,
                              void* stream) {
  if (B > 0) {
    const long long threads = (long long)B * kHornerSlots;
    fold_horner_kernel<<<(unsigned)((threads + kHornerThreads - 1) /
                                    kHornerThreads),
                         kHornerThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)partials, (uint32_t*)out, B, planes, times,
        modulus_from_words(mod));
  }
  return (int)cudaGetLastError();
}

extern "C" int h2_fold_add(const void* p, const void* q, void* out,
                           long long lanes, const uint32_t* mod,
                           void* stream) {
  if (lanes > 0) {
    fold_add_kernel<<<blocks_for(lanes), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, lanes,
        modulus_from_words(mod));
  }
  return (int)cudaGetLastError();
}

extern "C" int h2_fold_dbl(const void* p, void* out, long long lanes,
                           int times, const uint32_t* mod, void* stream) {
  if (lanes > 0) {
    fold_dbl_kernel<<<blocks_for(lanes), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)p, (uint32_t*)out, lanes, times,
        modulus_from_words(mod));
  }
  return (int)cudaGetLastError();
}
