// Kernel 1: lanewise Montgomery multiply over Fr or Fq, and its power.
//
// mont_mul replaces the Pallas kernel
// halo2tpu/ops/pallas_field.py::_mont_mul_lane_tiled (entry mont_mul_flat,
// body _mm_kernel_for -> mont_mul_lm -> _mont_reduce),
// which runs SOS reduction on (16, T) tiles of 16-bit limbs with the two
// constant convolutions on the MXU.
//
// Bound on the H100: a product is ~128 32-bit multiply-adds against 96
// bytes moved, so on large arrays memory bandwidth binds first (measured at
// 2^20 lanes: ~2.6 TB/s of operand traffic, PERF.md) with the integer
// multiply rate close behind.  Design: one thread per element, the eight
// 32-bit limbs of each operand in registers, field.cuh's carry-chain CIOS,
// 16-byte vector loads, grid-stride loop.  When both operands are the same
// buffer the kernel reads it once and takes field.cuh's squaring (36 limb
// products instead of 64); a Montgomery square in canonical form is unique,
// so the bits are those of the product.
//
// mont_pow (fe_pow) replaces halo2tpu/fields/jfield.py::mont_pow, the XLA
// fori_loop over the exponent's bits that every Fermat inversion runs
// (jfield.inv: a^(p-2)), which the port ran as one 1-lane mont_mul launch
// per product and per squaring (380 launches for Fr, 363 for Fq).  Bound:
// latency.  The inversions of a proof are 1-lane calls, and a^e is a
// serial chain of bit_length(e) - 1 squarings and popcount(e) products
// (253 + 127 for Fr's p - 2, 253 + 110 for Fq's) that no lane can split.
// Design: one thread a lane walks the exponent's bits from the lowest up,
// the same square-and-multiply as the loop it replaces (result *= base on a
// set bit, then base squared unless it was the top bit), with result and
// base in registers and the exponent a __grid_constant__ parameter, so the
// whole chain is one launch.
#include "field.cuh"

namespace {

// An exponent: eight little-endian words and its bit length.
struct Exponent {
  uint32_t w[H2_LIMBS];
  int nbits;
};

template <bool kSquare>
__global__ void mont_mul_kernel(const uint32_t* __restrict__ a,
                                const uint32_t* __restrict__ b,
                                uint32_t* __restrict__ out, long long n,
                                const __grid_constant__ Modulus M) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const Fe x = fe_load(a + i * H2_LIMBS);
    const Fe r = kSquare ? fe_sqr(x, M)
                         : fe_mul(x, fe_load(b + i * H2_LIMBS), M);
    fe_store(out + i * H2_LIMBS, r);
  }
}

__global__ void mont_pow_kernel(const uint32_t* __restrict__ a,
                                uint32_t* __restrict__ out, long long n,
                                const __grid_constant__ Exponent E,
                                const __grid_constant__ Modulus M) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    Fe base = fe_load(a + i * H2_LIMBS);
    Fe result = fe_const(M.one);
    for (int k = 0; k < E.nbits; k++) {
      if ((E.w[k >> 5] >> (k & 31)) & 1u) result = fe_mul(result, base, M);
      if (k + 1 < E.nbits) base = fe_sqr(base, M);
    }
    fe_store(out + i * H2_LIMBS, result);
  }
}

// Each lane: `steps` dependent products x = x * y, or squarings x = x^2.
// Not a kernel of any path: its time over two step counts at one lane gives
// the latency of one dependent product or squaring on the card (the unit
// of the latency floors of fe_pow and fold_horner), and at many lanes the
// product rate the card sustains (chip_smoke.py).
__global__ void mont_chain_kernel(const uint32_t* __restrict__ x,
                                  const uint32_t* __restrict__ y,
                                  uint32_t* __restrict__ out, long long n,
                                  int steps, int square,
                                  const __grid_constant__ Modulus M) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe a = fe_load(x + i * H2_LIMBS);
  const Fe b = fe_load(y + i * H2_LIMBS);
  if (square) {
    for (int k = 0; k < steps; k++) a = fe_sqr(a, M);
  } else {
    for (int k = 0; k < steps; k++) a = fe_mul(a, b, M);
  }
  fe_store(out + i * H2_LIMBS, a);
}

long long grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  return blocks > 65535LL * 32 ? 65535LL * 32 : blocks;
}

}  // namespace

// mod: 17 words (p[8], inv, one[8]).  a == b squares.  Returns
// cudaGetLastError().
extern "C" int h2_mont_mul(const void* a, const void* b, void* out,
                           long long n, const uint32_t* mod, void* stream) {
  const Modulus M = modulus_from_words(mod);
  const int threads = 256;
  if (n > 0) {
    const auto kernel =
        a == b ? mont_mul_kernel<true> : mont_mul_kernel<false>;
    kernel<<<(unsigned)grid_for(n, threads), threads, 0,
             (cudaStream_t)stream>>>((const uint32_t*)a, (const uint32_t*)b,
                                     (uint32_t*)out, n, M);
  }
  return (int)cudaGetLastError();
}

// out = a^e lanewise; exp: 8 words of e (little-endian), nbits its bit
// length (at most 256; 0 gives Montgomery one).  Returns
// cudaGetLastError().
extern "C" int h2_mont_pow(const void* a, void* out, long long n,
                           const uint32_t* exp, int nbits,
                           const uint32_t* mod, void* stream) {
  const Modulus M = modulus_from_words(mod);
  Exponent E;
  for (int i = 0; i < H2_LIMBS; i++) E.w[i] = exp[i];
  E.nbits = nbits;
  const int threads = 128;
  if (n > 0) {
    mont_pow_kernel<<<(unsigned)grid_for(n, threads), threads, 0,
                      (cudaStream_t)stream>>>((const uint32_t*)a,
                                              (uint32_t*)out, n, E, M);
  }
  return (int)cudaGetLastError();
}

// out = x * y^steps * 2^(-256 steps), or x^(2^steps) in Montgomery form
// (square != 0), lanewise over n lanes, one thread a lane.  Returns
// cudaGetLastError().
extern "C" int h2_mont_chain(const void* x, const void* y, void* out,
                             long long n, int steps, int square,
                             const uint32_t* mod, void* stream) {
  const int threads = 128;
  if (n > 0) {
    mont_chain_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                        (cudaStream_t)stream>>>(
        (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)out, n, steps,
        square, modulus_from_words(mod));
  }
  return (int)cudaGetLastError();
}
