// 256-bit Montgomery field arithmetic for one thread: eight 32-bit limbs,
// little-endian, values canonical in [0, p), Montgomery form with R = 2^256.
// Shared by mont_mul.cu and ec_fold.cu, whose kernels take the modulus as a
// `const __grid_constant__ Modulus` parameter.
//
// One Montgomery product is 64 + 64 32x32->64 multiplies plus carries, so
// kernels that chain many products per element (the point folds) are bound
// by 32-bit integer multiply throughput.  Every limb step here is one PTX
// multiply-add on the carry flag (mad.lo.cc / madc.hi.cc), so a product of
// eight limbs by one is 17 instructions with no separate carry arithmetic.
// A carry chain lives inside one asm statement (the flag does not survive
// between statements); the statements are not volatile, so the compiler
// may interleave independent products.  fe_mul is CIOS: each round adds
// a * b_i, then m * p with m = t_0 * inv, and shifts one word.  fe_sqr forms
// a * a from its 28 distinct cross products (doubled) and 8 squares, then
// reduces the 16-word product word by word (SOS).  Both need p < 2^254 (BN254's
// r and q): then no partial sum carries past the words used below.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define H2_LIMBS 8

// Modulus constants, passed by value as a kernel parameter (constant bank).
struct Modulus {
  uint32_t p[H2_LIMBS];    // the modulus
  uint32_t inv;            // -p^-1 mod 2^32
  uint32_t one[H2_LIMBS];  // 2^256 mod p (Montgomery one)
};

// Host side: 17 words as the wrappers pass them (p[8], inv, one[8]).
inline Modulus modulus_from_words(const uint32_t* mod) {
  Modulus M;
  for (int i = 0; i < H2_LIMBS; i++) M.p[i] = mod[i];
  M.inv = mod[H2_LIMBS];
  for (int i = 0; i < H2_LIMBS; i++) M.one[i] = mod[H2_LIMBS + 1 + i];
  return M;
}

struct Fe {
  uint32_t v[H2_LIMBS];
};

__device__ __forceinline__ Fe fe_load(const uint32_t* ptr) {
  const uint4 lo = *reinterpret_cast<const uint4*>(ptr);
  const uint4 hi = *reinterpret_cast<const uint4*>(ptr + 4);
  Fe r;
  r.v[0] = lo.x; r.v[1] = lo.y; r.v[2] = lo.z; r.v[3] = lo.w;
  r.v[4] = hi.x; r.v[5] = hi.y; r.v[6] = hi.z; r.v[7] = hi.w;
  return r;
}

__device__ __forceinline__ void fe_store(uint32_t* ptr, const Fe& a) {
  *reinterpret_cast<uint4*>(ptr) = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  *reinterpret_cast<uint4*>(ptr + 4) =
      make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < H2_LIMBS; i++) acc |= a.v[i];
  return acc == 0;
}

__device__ __forceinline__ bool fe_eq(const Fe& a, const Fe& b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < H2_LIMBS; i++) acc |= a.v[i] ^ b.v[i];
  return acc == 0;
}

__device__ __forceinline__ Fe fe_const(const uint32_t c[H2_LIMBS]) {
  Fe r;
#pragma unroll
  for (int i = 0; i < H2_LIMBS; i++) r.v[i] = c[i];
  return r;
}

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < H2_LIMBS; i++) r.v[i] = 0;
  return r;
}

// d = a - b over eight words; returns the borrow out as 0 or 0xFFFFFFFF.
__device__ __forceinline__ uint32_t sub8(uint32_t d[8], const uint32_t a[8],
                                         const uint32_t b[8]) {
  uint32_t borrow;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]),
        "=r"(d[5]), "=r"(d[6]), "=r"(d[7]), "=r"(borrow)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  return borrow;
}

// s = a + b over eight words; returns the carry out (0 or 1).
__device__ __forceinline__ uint32_t add8(uint32_t s[8], const uint32_t a[8],
                                         const uint32_t b[8]) {
  uint32_t carry;
  asm("add.cc.u32 %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32 %8, 0, 0;"
      : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(s[4]),
        "=r"(s[5]), "=r"(s[6]), "=r"(s[7]), "=r"(carry)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  return carry;
}

// r = a - p if a >= p (or if a carries a 2^256 bit), else a.
__device__ __forceinline__ Fe fe_reduce_once(const Fe& a, uint32_t top,
                                             const Modulus& M) {
  Fe d;
  const uint32_t borrow = sub8(d.v, a.v, M.p);
  return (top != 0 || borrow == 0) ? d : a;
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b,
                                     const Modulus& M) {
  Fe s;
  const uint32_t carry = add8(s.v, a.v, b.v);
  return fe_reduce_once(s, carry, M);
}

__device__ __forceinline__ Fe fe_dbl(const Fe& a, const Modulus& M) {
  return fe_add(a, a, M);
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b,
                                     const Modulus& M) {
  Fe d;
  const uint32_t borrow = sub8(d.v, a.v, b.v);
  uint32_t pm[H2_LIMBS];
#pragma unroll
  for (int i = 0; i < H2_LIMBS; i++) pm[i] = M.p[i] & borrow;
  Fe r;
  add8(r.v, d.v, pm);
  return r;
}

// t[0..8] += a[0..7] * b: the low halves on one carry chain ending in t[8],
// the high halves on a second one from t[1] to t[8].  The caller's bound
// keeps the sum below 2^288, so nothing carries out of t[8].
__device__ __forceinline__ void mac_row(uint32_t t[9], const uint32_t a[8],
                                        uint32_t b) {
  asm("mad.lo.cc.u32 %0, %9, %17, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
      "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
      "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
      "addc.u32 %8, %8, 0;\n\t"
      "mad.hi.cc.u32 %1, %9, %17, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %17, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %17, %6;\n\t"
      "madc.hi.cc.u32 %7, %15, %17, %7;\n\t"
      "madc.hi.u32 %8, %16, %17, %8;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b));
}

// mac_row for a word of a longer sum: the carry c left by the previous row
// goes into t[8] beside this row's low-chain carry, and c becomes the carry
// out of t[8] (at most 2), which belongs to the next word up.
__device__ __forceinline__ void mac_row_carry(uint32_t t[9],
                                              const uint32_t a[8], uint32_t b,
                                              uint32_t& c) {
  asm("mad.lo.cc.u32 %0, %10, %18, %0;\n\t"
      "madc.lo.cc.u32 %1, %11, %18, %1;\n\t"
      "madc.lo.cc.u32 %2, %12, %18, %2;\n\t"
      "madc.lo.cc.u32 %3, %13, %18, %3;\n\t"
      "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
      "madc.lo.cc.u32 %5, %15, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %16, %18, %6;\n\t"
      "madc.lo.cc.u32 %7, %17, %18, %7;\n\t"
      "addc.cc.u32 %8, %8, %9;\n\t"
      "addc.u32 %9, 0, 0;\n\t"
      "mad.hi.cc.u32 %1, %10, %18, %1;\n\t"
      "madc.hi.cc.u32 %2, %11, %18, %2;\n\t"
      "madc.hi.cc.u32 %3, %12, %18, %3;\n\t"
      "madc.hi.cc.u32 %4, %13, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %14, %18, %5;\n\t"
      "madc.hi.cc.u32 %6, %15, %18, %6;\n\t"
      "madc.hi.cc.u32 %7, %16, %18, %7;\n\t"
      "madc.hi.cc.u32 %8, %17, %18, %8;\n\t"
      "addc.u32 %9, %9, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(c)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b));
}

// Montgomery product a * b * 2^-256 mod p, CIOS, canonical output.
// Inputs canonical (< p < 2^254): before each round t < 2p, after adding
// a * b_i and m * p it is below 2p * 2^32 + 2^286 < 2^288 (nine words), and
// after the shift below 2p again, so one final subtraction suffices.
// fe_mul is one out-of-line copy of it: a point formula calls it 7 to 11
// times, and a copy of its ~600 instructions at every call site made the
// point kernels' code larger than the instruction cache (fold_mixed's ran
// slower inlined).  fe_mul_inline is the body, for a kernel with few call
// sites on a latency-bound path (fold_horner's group steps: no call, no
// argument moves).  M should be a __grid_constant__ kernel parameter, so
// that passing its address copies nothing to local memory.
__device__ __forceinline__ Fe fe_mul_inline(const Fe& a, const Fe& b,
                                            const Modulus& M) {
  uint32_t t[H2_LIMBS + 1];
#pragma unroll
  for (int i = 0; i < H2_LIMBS + 1; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < H2_LIMBS; i++) {
    mac_row(t, a.v, b.v[i]);
    mac_row(t, M.p, t[0] * M.inv);   // t[0] becomes 0
#pragma unroll
    for (int j = 0; j < H2_LIMBS; j++) t[j] = t[j + 1];
    t[H2_LIMBS] = 0;
  }
  Fe r;
#pragma unroll
  for (int i = 0; i < H2_LIMBS; i++) r.v[i] = t[i];
  return fe_reduce_once(r, 0, M);
}

static __device__ __noinline__ Fe fe_mul(const Fe a, const Fe b,
                                         const Modulus& M) {
  return fe_mul_inline(a, b, M);
}

// a * a * 2^-256 mod p, canonical output.  The 16-word square w is built
// from the 28 cross products x_i x_j (i < j), each taken once, then doubled,
// then the 8 squares x_i^2 added; then eight reduction rounds (SOS) add
// m * p at word i with m = w[i] * inv.  Every chain stays inside its bound:
// - cross row i (x_i times x_{i+1..7}) puts its low halves at words 2i+1 ..
//   i+7 with the carry in word i+8, still zero, and its high halves at
//   words 2i+2 .. i+8; after row i the sum is below 2^(32 (i + 9)), so the
//   high chain does not carry out of word i+8;
// - the doubled cross sum is below 2^481 and the full square below 2^512;
// - a round's carry out of word i+8 goes into word i+9 in the next round;
//   the total a * a + sum m_i p 2^(32 i) < p^2 + 2^256 p < 2^511 never
//   carries past word 15, and w[8..15] < 2p.
__device__ __forceinline__ Fe fe_sqr(const Fe& a, const Modulus& M) {
  const uint32_t* x = a.v;
  uint32_t w[2 * H2_LIMBS];
#pragma unroll
  for (int i = 0; i < 2 * H2_LIMBS; i++) w[i] = 0;
  asm(
      // row 0: x0 * x1..x7
      "mad.lo.cc.u32 %1, %16, %17, %1;\n\t"
      "madc.lo.cc.u32 %2, %16, %18, %2;\n\t"
      "madc.lo.cc.u32 %3, %16, %19, %3;\n\t"
      "madc.lo.cc.u32 %4, %16, %20, %4;\n\t"
      "madc.lo.cc.u32 %5, %16, %21, %5;\n\t"
      "madc.lo.cc.u32 %6, %16, %22, %6;\n\t"
      "madc.lo.cc.u32 %7, %16, %23, %7;\n\t"
      "addc.u32 %8, %8, 0;\n\t"
      "mad.hi.cc.u32 %2, %16, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %16, %18, %3;\n\t"
      "madc.hi.cc.u32 %4, %16, %19, %4;\n\t"
      "madc.hi.cc.u32 %5, %16, %20, %5;\n\t"
      "madc.hi.cc.u32 %6, %16, %21, %6;\n\t"
      "madc.hi.cc.u32 %7, %16, %22, %7;\n\t"
      "madc.hi.u32 %8, %16, %23, %8;\n\t"
      // row 1: x1 * x2..x7
      "mad.lo.cc.u32 %3, %17, %18, %3;\n\t"
      "madc.lo.cc.u32 %4, %17, %19, %4;\n\t"
      "madc.lo.cc.u32 %5, %17, %20, %5;\n\t"
      "madc.lo.cc.u32 %6, %17, %21, %6;\n\t"
      "madc.lo.cc.u32 %7, %17, %22, %7;\n\t"
      "madc.lo.cc.u32 %8, %17, %23, %8;\n\t"
      "addc.u32 %9, %9, 0;\n\t"
      "mad.hi.cc.u32 %4, %17, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %17, %19, %5;\n\t"
      "madc.hi.cc.u32 %6, %17, %20, %6;\n\t"
      "madc.hi.cc.u32 %7, %17, %21, %7;\n\t"
      "madc.hi.cc.u32 %8, %17, %22, %8;\n\t"
      "madc.hi.u32 %9, %17, %23, %9;\n\t"
      // row 2: x2 * x3..x7
      "mad.lo.cc.u32 %5, %18, %19, %5;\n\t"
      "madc.lo.cc.u32 %6, %18, %20, %6;\n\t"
      "madc.lo.cc.u32 %7, %18, %21, %7;\n\t"
      "madc.lo.cc.u32 %8, %18, %22, %8;\n\t"
      "madc.lo.cc.u32 %9, %18, %23, %9;\n\t"
      "addc.u32 %10, %10, 0;\n\t"
      "mad.hi.cc.u32 %6, %18, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %18, %20, %7;\n\t"
      "madc.hi.cc.u32 %8, %18, %21, %8;\n\t"
      "madc.hi.cc.u32 %9, %18, %22, %9;\n\t"
      "madc.hi.u32 %10, %18, %23, %10;\n\t"
      // row 3: x3 * x4..x7
      "mad.lo.cc.u32 %7, %19, %20, %7;\n\t"
      "madc.lo.cc.u32 %8, %19, %21, %8;\n\t"
      "madc.lo.cc.u32 %9, %19, %22, %9;\n\t"
      "madc.lo.cc.u32 %10, %19, %23, %10;\n\t"
      "addc.u32 %11, %11, 0;\n\t"
      "mad.hi.cc.u32 %8, %19, %20, %8;\n\t"
      "madc.hi.cc.u32 %9, %19, %21, %9;\n\t"
      "madc.hi.cc.u32 %10, %19, %22, %10;\n\t"
      "madc.hi.u32 %11, %19, %23, %11;\n\t"
      // row 4: x4 * x5..x7
      "mad.lo.cc.u32 %9, %20, %21, %9;\n\t"
      "madc.lo.cc.u32 %10, %20, %22, %10;\n\t"
      "madc.lo.cc.u32 %11, %20, %23, %11;\n\t"
      "addc.u32 %12, %12, 0;\n\t"
      "mad.hi.cc.u32 %10, %20, %21, %10;\n\t"
      "madc.hi.cc.u32 %11, %20, %22, %11;\n\t"
      "madc.hi.u32 %12, %20, %23, %12;\n\t"
      // row 5: x5 * x6..x7
      "mad.lo.cc.u32 %11, %21, %22, %11;\n\t"
      "madc.lo.cc.u32 %12, %21, %23, %12;\n\t"
      "addc.u32 %13, %13, 0;\n\t"
      "mad.hi.cc.u32 %12, %21, %22, %12;\n\t"
      "madc.hi.u32 %13, %21, %23, %13;\n\t"
      // row 6: x6 * x7..x7
      "mad.lo.cc.u32 %13, %22, %23, %13;\n\t"
      "addc.u32 %14, %14, 0;\n\t"
      "mad.hi.u32 %14, %22, %23, %14;"
      : "+r"(w[0]), "+r"(w[1]), "+r"(w[2]), "+r"(w[3]), "+r"(w[4]),
        "+r"(w[5]), "+r"(w[6]), "+r"(w[7]), "+r"(w[8]), "+r"(w[9]),
        "+r"(w[10]), "+r"(w[11]), "+r"(w[12]), "+r"(w[13]), "+r"(w[14]),
        "+r"(w[15])
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]),
        "r"(x[6]), "r"(x[7]));
  // double the cross sum (words 1..14, carry into 15), add the squares
  asm(
      "add.cc.u32 %1, %1, %1;\n\t"
      "addc.cc.u32 %2, %2, %2;\n\t"
      "addc.cc.u32 %3, %3, %3;\n\t"
      "addc.cc.u32 %4, %4, %4;\n\t"
      "addc.cc.u32 %5, %5, %5;\n\t"
      "addc.cc.u32 %6, %6, %6;\n\t"
      "addc.cc.u32 %7, %7, %7;\n\t"
      "addc.cc.u32 %8, %8, %8;\n\t"
      "addc.cc.u32 %9, %9, %9;\n\t"
      "addc.cc.u32 %10, %10, %10;\n\t"
      "addc.cc.u32 %11, %11, %11;\n\t"
      "addc.cc.u32 %12, %12, %12;\n\t"
      "addc.cc.u32 %13, %13, %13;\n\t"
      "addc.cc.u32 %14, %14, %14;\n\t"
      "addc.u32 %15, 0, 0;\n\t"
      "mad.lo.cc.u32 %0, %16, %16, %0;\n\t"
      "madc.hi.cc.u32 %1, %16, %16, %1;\n\t"
      "madc.lo.cc.u32 %2, %17, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %17, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %18, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %18, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %19, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %19, %19, %7;\n\t"
      "madc.lo.cc.u32 %8, %20, %20, %8;\n\t"
      "madc.hi.cc.u32 %9, %20, %20, %9;\n\t"
      "madc.lo.cc.u32 %10, %21, %21, %10;\n\t"
      "madc.hi.cc.u32 %11, %21, %21, %11;\n\t"
      "madc.lo.cc.u32 %12, %22, %22, %12;\n\t"
      "madc.hi.cc.u32 %13, %22, %22, %13;\n\t"
      "madc.lo.cc.u32 %14, %23, %23, %14;\n\t"
      "madc.hi.u32 %15, %23, %23, %15;"
      : "+r"(w[0]), "+r"(w[1]), "+r"(w[2]), "+r"(w[3]), "+r"(w[4]),
        "+r"(w[5]), "+r"(w[6]), "+r"(w[7]), "+r"(w[8]), "+r"(w[9]),
        "+r"(w[10]), "+r"(w[11]), "+r"(w[12]), "+r"(w[13]), "+r"(w[14]),
        "+r"(w[15])
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]),
        "r"(x[6]), "r"(x[7]));
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < H2_LIMBS; i++) {
    mac_row_carry(w + i, M.p, w[i] * M.inv, c);   // w[i] becomes 0
  }
  Fe r;
#pragma unroll
  for (int i = 0; i < H2_LIMBS; i++) r.v[i] = w[H2_LIMBS + i];
  return fe_reduce_once(r, 0, M);
}
