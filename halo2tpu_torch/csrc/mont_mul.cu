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
// latency.  The inversions of a proof are calls of one to a few dozen
// lanes, and a^e is a serial chain of bit_length(e) - 1 squarings and
// popcount(e) products (253 + 127 for Fr's p - 2, 253 + 110 for Fq's) that
// no lane can split.  Design: two warps a block of 32 lanes, the whole
// chain one launch: the squaring warp computes base^(2^k) in turn and hands
// each one a set bit needs to the product warp through a ring of kRing
// slots in shared memory, each slot with two named barriers (full: the
// squaring warp arrives, the product warp waits; empty: the other way
// round), so the products run beside the squarings and the path is the
// squarings, then one product.  The two warps sit on different schedulers;
// lanes of one warp on the two chains would diverge and take turns.  One
// thread a lane (both chains on one path) and lockstep pairs of lanes (both
// running fe_mul every step, the path bit_length(e) products) were slower at
// 1, 80 and 4,097 lanes (PERF.md, row 10).
#include "field.cuh"

namespace {

// An exponent: eight little-endian words, its bit length and popcount.
struct Exponent {
  uint32_t w[H2_LIMBS];
  int nbits;
  int ones;
};

constexpr int kRing = 7;   // slots; named barriers 1..7 full, 8..14 empty

__device__ __forceinline__ bool exp_bit(const Exponent& E, int k) {
  return (E.w[k >> 5] >> (k & 31)) & 1u;
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_wait(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

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

// Two warps, lanes blockIdx.x * 32 + l: warp 0 squares, warp 1 multiplies.
// The m-th set bit's power goes to slot m % kRing; the squaring warp waits
// for the slot to be empty (item m - kRing read) before it writes item m.
// The first product is by one: skipped (a canonical x times one is x).
__global__ void __launch_bounds__(64)
mont_pow_kernel(const uint32_t* __restrict__ a,
                     uint32_t* __restrict__ out, long long n,
                     const __grid_constant__ Exponent E,
                     const __grid_constant__ Modulus M) {
  __shared__ uint4 ring[kRing][32][2];
  const int lane = threadIdx.x & 31;
  const long long i = blockIdx.x * 32LL + lane;
  const bool live = i < n;
  if (threadIdx.x < 32) {
    Fe base = live ? fe_load(a + i * H2_LIMBS) : fe_zero();
    int m = 0;
    for (int k = 0; k < E.nbits; k++) {
      if (exp_bit(E, k)) {
        const int slot = m % kRing;
        if (m >= kRing) bar_wait(1 + kRing + slot);
        ring[slot][lane][0] = make_uint4(base.v[0], base.v[1], base.v[2],
                                         base.v[3]);
        ring[slot][lane][1] = make_uint4(base.v[4], base.v[5], base.v[6],
                                         base.v[7]);
        __threadfence_block();
        bar_arrive(1 + slot);
        m++;
      }
      if (k + 1 < E.nbits) base = fe_sqr(base, M);
    }
  } else {
    Fe result = fe_const(M.one);
    for (int m = 0; m < E.ones; m++) {
      const int slot = m % kRing;
      bar_wait(1 + slot);
      const uint4 lo = ring[slot][lane][0], hi = ring[slot][lane][1];
      if (m + kRing < E.ones) {
        __threadfence_block();
        bar_arrive(1 + kRing + slot);
      }
      const Fe x = {{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
      result = m == 0 ? x : fe_mul_inline(result, x, M);
    }
    if (live) fe_store(out + i * H2_LIMBS, result);
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
  E.ones = 0;
  for (int i = 0; i < H2_LIMBS; i++) {
    E.w[i] = exp[i];
    E.ones += __builtin_popcount(exp[i]);
  }
  E.nbits = nbits;
  if (nbits < 0 || nbits > 256 || n > 0x3FFFFFFFLL * 32)
    return (int)cudaErrorInvalidValue;
  if (n > 0)
    mont_pow_kernel<<<(unsigned)((n + 31) / 32), 64, 0,
                           (cudaStream_t)stream>>>(
        (const uint32_t*)a, (uint32_t*)out, n, E, M);
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
