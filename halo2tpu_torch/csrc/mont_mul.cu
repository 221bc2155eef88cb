// Kernel 1: lanewise Montgomery multiply over Fr or Fq.
//
// Replaces the Pallas kernel
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
#include "field.cuh"

namespace {

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

}  // namespace

// mod: 17 words (p[8], inv, one[8]).  a == b squares.  Returns
// cudaGetLastError().
extern "C" int h2_mont_mul(const void* a, const void* b, void* out,
                           long long n, const uint32_t* mod, void* stream) {
  const Modulus M = modulus_from_words(mod);
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  if (n > 0) {
    const auto kernel =
        a == b ? mont_mul_kernel<true> : mont_mul_kernel<false>;
    kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, M);
  }
  return (int)cudaGetLastError();
}
