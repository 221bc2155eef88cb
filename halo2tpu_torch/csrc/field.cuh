// 256-bit Montgomery field arithmetic for one thread: eight 32-bit limbs,
// little-endian, values canonical in [0, p), Montgomery form with R = 2^256.
// Shared by mont_mul.cu and ec_fold.cu.
//
// One Montgomery product is 64 + 64 32x32->64 multiplies plus carries, so
// kernels that chain many products per element (the point folds) are bound
// by 32-bit integer multiply throughput (IMAD / IMAD.WIDE).  The simple
// design here keeps every operand in registers (one element per thread),
// uses CIOS reduction with 64-bit accumulators so the compiler can emit
// wide multiply-adds, and fully unrolls the limb loops.
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

// r = a - p if a >= p (or if a carries a 2^256 bit), else a.
__device__ __forceinline__ Fe fe_reduce_once(const Fe& a, uint32_t top,
                                             const Modulus& M) {
  Fe d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < H2_LIMBS; i++) {
    const uint64_t s = (uint64_t)a.v[i] - M.p[i] - borrow;
    d.v[i] = (uint32_t)s;
    borrow = s >> 63;
  }
  return (top != 0 || borrow == 0) ? d : a;
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b,
                                     const Modulus& M) {
  Fe s;
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < H2_LIMBS; i++) {
    const uint64_t t = (uint64_t)a.v[i] + b.v[i] + carry;
    s.v[i] = (uint32_t)t;
    carry = t >> 32;
  }
  return fe_reduce_once(s, (uint32_t)carry, M);
}

__device__ __forceinline__ Fe fe_dbl(const Fe& a, const Modulus& M) {
  return fe_add(a, a, M);
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b,
                                     const Modulus& M) {
  Fe d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < H2_LIMBS; i++) {
    const uint64_t t = (uint64_t)a.v[i] - b.v[i] - borrow;
    d.v[i] = (uint32_t)t;
    borrow = t >> 63;
  }
  if (borrow) {
    uint64_t carry = 0;
#pragma unroll
    for (int i = 0; i < H2_LIMBS; i++) {
      const uint64_t t = (uint64_t)d.v[i] + M.p[i] + carry;
      d.v[i] = (uint32_t)t;
      carry = t >> 32;
    }
  }
  return d;
}

// Montgomery product a * b * 2^-256 mod p, CIOS, canonical output.
// Inputs canonical (< p < 2^254), so the running value stays < 2p and the
// final subtraction is the only one needed.
__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b,
                                     const Modulus& M) {
  uint32_t t[H2_LIMBS + 2];
#pragma unroll
  for (int i = 0; i < H2_LIMBS + 2; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < H2_LIMBS; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < H2_LIMBS; j++) {
      const uint64_t s = (uint64_t)a.v[j] * b.v[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[H2_LIMBS] + c;
    t[H2_LIMBS] = (uint32_t)s;
    t[H2_LIMBS + 1] = (uint32_t)(s >> 32);

    const uint32_t m = t[0] * M.inv;
    s = (uint64_t)m * M.p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < H2_LIMBS; j++) {
      s = (uint64_t)m * M.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[H2_LIMBS] + c;
    t[H2_LIMBS - 1] = (uint32_t)s;
    t[H2_LIMBS] = t[H2_LIMBS + 1] + (uint32_t)(s >> 32);
  }
  Fe r;
#pragma unroll
  for (int i = 0; i < H2_LIMBS; i++) r.v[i] = t[i];
  return fe_reduce_once(r, t[H2_LIMBS], M);
}

__device__ __forceinline__ Fe fe_sqr(const Fe& a, const Modulus& M) {
  return fe_mul(a, a, M);
}
