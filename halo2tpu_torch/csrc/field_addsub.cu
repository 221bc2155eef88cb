// Kernel: lanewise a + b, a - b and -a mod p over Fr or Fq.
//
// Replaces halo2tpu/fields/jfield.py::add, sub and neg: XLA carry chains
// over 16-bit limbs, fused by XLA into whatever surrounds them.  The port
// had run each as 15-20 torch launches (limbs widened to int64, the carry
// chain built from torch ops).  Here one launch does the whole operation.
//
// Bound on the H100: the bytes (two operands read, one result written, 96
// bytes a lane, against two 8-word carry chains).  Design: one thread a
// lane, grid-stride, 16-byte loads, field.cuh's add/sub carry chains.  An
// operand may be broadcast: lane i reads its element (i / div) % mod, which
// covers a column of rows across a stack ((n, C) + (n, 1)), one element
// for every lane ((n,) + ()), and a vector repeated along a leading axis;
// the wrapper (ops/cuda_field.py) copies any other broadcast out first.
#include "field.cuh"

namespace {

enum Op : int { kAdd = 0, kSub = 1, kNeg = 2 };

struct Operand {
  const uint32_t* ptr;
  long long div;
  long long mod;
};

__device__ __forceinline__ Fe operand_get(const Operand& X, long long i) {
  long long j = 0;
  if (X.mod != 1) {
    j = X.div == 1 ? i : i / X.div;
    if (j >= X.mod) j %= X.mod;
  }
  return fe_load(X.ptr + j * H2_LIMBS);
}

__global__ void field_addsub_kernel(const __grid_constant__ Operand A,
                                    const __grid_constant__ Operand B,
                                    uint32_t* __restrict__ out, long long n,
                                    int op,
                                    const __grid_constant__ Modulus M) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const Fe a = operand_get(A, i);
    Fe r;
    if (op == kNeg) {
      r = fe_sub(fe_zero(), a, M);
    } else {
      const Fe b = operand_get(B, i);
      r = op == kAdd ? fe_add(a, b, M) : fe_sub(a, b, M);
    }
    fe_store(out + i * H2_LIMBS, r);
  }
}

}  // namespace

// out[i] = a op b (op 0 add, 1 sub) or -a (op 2, b unused) over n lanes;
// operand x's lane i is element (i / x_div) % x_mod of x.  mod: 17 words
// (p[8], inv, one[8]).  Returns cudaGetLastError().
extern "C" int h2_field_addsub(const void* a, long long a_div,
                               long long a_mod, const void* b,
                               long long b_div, long long b_mod, void* out,
                               long long n, int op, const uint32_t* mod,
                               void* stream) {
  const Modulus M = modulus_from_words(mod);
  if (op < kAdd || op > kNeg || a_div < 1 || a_mod < 1 || b_div < 1 ||
      b_mod < 1)
    return (int)cudaErrorInvalidValue;
  const Operand A{(const uint32_t*)a, a_div, a_mod};
  const Operand B{(const uint32_t*)b, b_div, b_mod};
  const int threads = 256;
  if (n > 0) {
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 65535LL * 32) blocks = 65535LL * 32;
    field_addsub_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(A, B, (uint32_t*)out, n, op,
                                                  M);
  }
  return (int)cudaGetLastError();
}
