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
//   fold_add_any  <- pallas_ec.py::fold_add_any (_add_kernel -> _padd_core);
//                    the same entry serves pallas_ec.py::fold_add, whose
//                    L % 512 == 0 rule the Python wrapper checks;
//   fold_dbl_any  <- pallas_ec.py::fold_dbl_any (_dbl_kernel -> _pdbl_lm).
//
// Bound on the H100: 32-bit integer multiply throughput, like mont_mul (a
// mixed add is 7 Montgomery products and 4 squarings, a full add 11 and 5, a
// doubling 2 and 5; fe_sqr runs the full product, so the squarings' saving,
// 36 instead of 64 limb products in a*a, is not taken yet).  The
// simple design keeps one accumulator per thread in registers for the whole
// row loop (fold_mixed reads its accumulator once and writes it once per
// launch), and branches around the work of masked and identity lanes.
// fold_mixed_tiled is one row per launch, as the Pallas kernel is: it reads
// and writes its accumulator once per row, and its C shared bases (24 KB at
// C = 256) stay in L1 instead of being broadcast to every lane in memory.
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
    return fe_is_zero(s2y1) ? pt_dbl(acc, M) : pt_identity(M);
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
  const Fe t1 = fe_mul(p.y, q.z, M);
  const Fe t2 = fe_mul(q.y, p.z, M);
  const Fe s1 = fe_mul(t1, z2z2, M);
  const Fe s2 = fe_mul(t2, z1z1, M);
  if (fe_eq(u1, u2)) {
    return fe_eq(s1, s2) ? pt_dbl(p, M) : pt_identity(M);
  }
  const Fe h = fe_sub(u2, u1, M);
  const Fe hh = fe_dbl(h, M);
  const Fe zz = fe_add(p.z, q.z, M);
  const Fe rr = fe_dbl(fe_sub(s2, s1, M), M);
  const Fe i = fe_sqr(hh, M);
  const Fe zzsq = fe_sqr(zz, M);
  const Fe r2 = fe_sqr(rr, M);
  const Fe j = fe_mul(h, i, M);
  const Fe v = fe_mul(u1, i, M);
  Pt o;
  o.x = fe_sub(fe_sub(r2, j, M), fe_dbl(v, M), M);
  const Fe rvx = fe_mul(rr, fe_sub(v, o.x, M), M);
  const Fe s1j = fe_mul(s1, j, M);
  o.z = fe_mul(fe_sub(fe_sub(zzsq, z1z1, M), z2z2, M), h, M);
  o.y = fe_sub(rvx, fe_dbl(s1j, M), M);
  return o;
}

// Lane l = g * C + c, g = plane * B + b.  For rows r in [r0, r1) the lane
// adds table[digit, r * C + c], digit = byte `plane` of scalar b at that
// base.  Table entries with Z = 0 (digit 0, padded bases) leave acc as is.
__global__ void fold_mixed_kernel(const uint32_t* __restrict__ acc_in,
                                  uint32_t* __restrict__ acc_out,
                                  const uint32_t* __restrict__ table,
                                  const uint32_t* __restrict__ scalars,
                                  long long lanes, int C, int B,
                                  long long npad, int r0, int r1, Modulus M) {
  const long long l = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const long long g = l / C;
  const int c = (int)(l - g * C);
  const int plane = (int)(g / B);
  const int b = (int)(g - (long long)plane * B);
  const int word = plane >> 2;
  const int shift = (plane & 3) * 8;
  Pt acc = pt_load(acc_in + l * 3 * H2_LIMBS);
  const uint32_t* sc = scalars + (long long)b * npad * H2_LIMBS + word;
  for (int r = r0; r < r1; r++) {
    const long long base = (long long)r * C + c;
    const uint32_t digit = (sc[base * H2_LIMBS] >> shift) & 0xFFu;
    const uint32_t* e =
        table + ((long long)digit * npad + base) * 3 * H2_LIMBS;
    const Fe z2 = fe_load(e + 2 * H2_LIMBS);
    if (fe_is_zero(z2)) continue;
    acc = pt_add_mixed(acc, fe_load(e), fe_load(e + H2_LIMBS), M);
  }
  pt_store(acc_out + l * 3 * H2_LIMBS, acc);
}

// Lane l adds pts_c[l mod C] where bits[l] != 0 (the Pallas tiled kernel's
// mask).  Bases with Z = 0 leave acc as is.
__global__ void fold_mixed_tiled_kernel(const uint32_t* __restrict__ acc_in,
                                        uint32_t* __restrict__ acc_out,
                                        const uint32_t* __restrict__ pts_c,
                                        const uint8_t* __restrict__ bits,
                                        long long lanes, int C, Modulus M) {
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

__global__ void fold_add_kernel(const uint32_t* __restrict__ p,
                                const uint32_t* __restrict__ q,
                                uint32_t* __restrict__ out, long long lanes,
                                Modulus M) {
  const long long l = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const Pt a = pt_load(p + l * 3 * H2_LIMBS);
  const Pt b = pt_load(q + l * 3 * H2_LIMBS);
  pt_store(out + l * 3 * H2_LIMBS, pt_add(a, b, M));
}

__global__ void fold_dbl_kernel(const uint32_t* __restrict__ p,
                                uint32_t* __restrict__ out, long long lanes,
                                Modulus M) {
  const long long l = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  pt_store(out + l * 3 * H2_LIMBS, pt_dbl(pt_load(p + l * 3 * H2_LIMBS), M));
}

constexpr int kThreads = 128;

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
        (const uint32_t*)scalars, lanes, C, B, npad, r0, r1, modulus_from_words(mod));
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
                           const uint32_t* mod, void* stream) {
  if (lanes > 0) {
    fold_dbl_kernel<<<blocks_for(lanes), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)p, (uint32_t*)out, lanes, modulus_from_words(mod));
  }
  return (int)cudaGetLastError();
}
