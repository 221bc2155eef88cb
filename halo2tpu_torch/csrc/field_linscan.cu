// Kernel: the linear scan x_j = v_j + a * x_(j-1) mod p along the rows of
// a vector or of each column of a stack, forward or reverse, for a
// constant a (a = 1: a prefix or suffix sum, no product), writing every
// x_j, every x_(j-1) (exclusive) or only the last.
//
// Replaces, in one to three launches a call:
// - halo2tpu/fields/jfield.py::_prefix_sum_mod / suffix_sum_mod (a = 1):
//   Hillis-Steele rounds of masked adds;
// - halo2tpu/plonk/engine.py::_div_linear_jit: vec(X) / (X - a), there power
//   vectors of a and 1/a around a suffix sum; here the exclusive reverse
//   scan with multiplier a, out_i = sum_(j>i) vec_j a^(j-i-1), with no
//   power vector and no inversion;
// - halo2tpu/plonk/engine.py::_eval_group_jit: a stack of polys evaluated at
//   x, there a power vector, a product and a tree sum; here the reverse
//   scan's total with a = x (Horner's rule), one launch a group.
// The port had run each as dozens of launches (one add a scan round, one
// product a power-vector round, one add a tree-sum round).
//
// Bound on the H100: the bytes (each element read once, written once) and,
// for a != 1, one product an element; at a proof's sizes (2^15 rows, one
// to a few dozen columns) a scan is a few microseconds of either, so the
// launches and the serial products bind.  Design: logical positions q =
// j + pad, with pad zeros put before the first element so that every
// block covers a whole chunk of 256 threads x `run` elements (a leading
// zero leaves x at 0, so it changes nothing).  A thread folds its run
// serially (run products), the block scans the 256 run totals in shared
// memory (Hillis-Steele, 8 rounds, round k multiplying by a^(run 2^k)),
// and each thread folds its run again from its incoming value, storing as
// it goes.  Across blocks: pass 1 writes each block's total, pass 2 (one
// block a column) scans the totals with multiplier a^chunk, exclusively,
// into each block's incoming carry, and pass 3 adds block b's carry
// times a^run to thread 0's run total before the block scan.  One block
// (n <= chunk) is one launch; a total over several blocks two (pass 2
// keeps only the last value).  The powers come from the host
// (ops/cuda_field.py::scan_shapes gives the schedule).
#include "field.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLog = 8;

enum Mode : int { kTotals = 0, kFull = 1 };

struct ScanPows {
  uint32_t a[H2_LIMBS];            // the multiplier
  uint32_t step[kLog][H2_LIMBS];   // a^(run 2^k)
};

template <bool kOne>
__device__ __forceinline__ Fe fold(const Fe& x, const Fe& v, const Fe& a,
                                   const Modulus& M) {
  if (kOne) return fe_add(x, v, M);
  return fe_add(fe_mul(x, a, M), v, M);
}

// grid (blocks a column, columns); element i of column c at src +
// c * col_stride + i * row_stride words.  Totals: dst[c * nb + b] =
// the block's last x.  Full: dst (cols, n, 8), element i of column c.
// carry (cols, nb, 8) or null: x before block b's first element.
template <bool kOne>
__global__ void __launch_bounds__(kThreads)
field_linscan_kernel(const uint32_t* __restrict__ src, long long row_stride,
                     long long col_stride, uint32_t* __restrict__ dst,
                     const uint32_t* __restrict__ carry, long long n,
                     int run, int mode, int reverse, int exclusive,
                     const __grid_constant__ ScanPows P,
                     const __grid_constant__ Modulus M) {
  __shared__ uint32_t sh[H2_LIMBS][kThreads];
  const int t = threadIdx.x;
  const long long b = blockIdx.x, nb = gridDim.x, col = blockIdx.y;
  const long long chunk = (long long)kThreads * run;
  const long long first = b * chunk + (long long)t * run - (nb * chunk - n);
  const uint32_t* base = src + col * col_stride;
  const Fe a = fe_const(P.a);
  auto load = [&](long long j) {
    if (j < 0) return fe_zero();
    const long long i = reverse ? n - 1 - j : j;
    return fe_load(base + i * row_stride);
  };

  Fe T = fe_zero();
  for (int s = 0; s < run; s++) T = fold<kOne>(T, load(first + s), a, M);
  Fe cin = fe_zero();
  if (carry != nullptr) {
    cin = fe_load(carry + (col * nb + b) * H2_LIMBS);
    if (t == 0)
      T = fe_add(T, kOne ? cin : fe_mul(cin, fe_const(P.step[0]), M), M);
  }
  // inclusive block scan of the run totals: after round k, T is the x at
  // the end of this run folded from the 2^(k+1) runs ending here
#pragma unroll 1
  for (int k = 0; k < kLog; k++) {
    const int d = 1 << k;
#pragma unroll
    for (int l = 0; l < H2_LIMBS; l++) sh[l][t] = T.v[l];
    __syncthreads();
    if (t >= d) {
      Fe y;
#pragma unroll
      for (int l = 0; l < H2_LIMBS; l++) y.v[l] = sh[l][t - d];
      T = fe_add(T, kOne ? y : fe_mul(y, fe_const(P.step[k]), M), M);
    }
    __syncthreads();
  }
  if (mode == kTotals) {
    if (t == kThreads - 1) fe_store(dst + (col * nb + b) * H2_LIMBS, T);
    return;
  }
#pragma unroll
  for (int l = 0; l < H2_LIMBS; l++) sh[l][t] = T.v[l];
  __syncthreads();
  Fe X = cin;
  if (t > 0) {
#pragma unroll
    for (int l = 0; l < H2_LIMBS; l++) X.v[l] = sh[l][t - 1];
  }
  uint32_t* out = dst + col * n * H2_LIMBS;
  for (int s = 0; s < run; s++) {
    const long long j = first + s;
    const Fe v = load(j);
    if (exclusive && j >= 0) {
      const long long i = reverse ? n - 1 - j : j;
      fe_store(out + i * H2_LIMBS, X);
    }
    X = fold<kOne>(X, v, a, M);
    if (!exclusive && j >= 0) {
      const long long i = reverse ? n - 1 - j : j;
      fe_store(out + i * H2_LIMBS, X);
    }
  }
}

template <bool kOne>
cudaError_t launch(const uint32_t* src, long long row_stride,
                   long long col_stride, uint32_t* dst,
                   const uint32_t* carry, long long n, long long nb,
                   long long cols, int run, int mode, int reverse,
                   int exclusive, const ScanPows& P, const Modulus& M,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)nb, (unsigned)cols);
  field_linscan_kernel<kOne><<<grid, kThreads, 0, stream>>>(
      src, row_stride, col_stride, dst, carry, n, run, mode, reverse,
      exclusive, P, M);
  return cudaGetLastError();
}

ScanPows pows_from_words(const uint32_t* w) {
  ScanPows P;
  for (int l = 0; l < H2_LIMBS; l++) P.a[l] = w[l];
  for (int k = 0; k < kLog; k++)
    for (int l = 0; l < H2_LIMBS; l++)
      P.step[k][l] = w[H2_LIMBS * (k + 1) + l];
  return P;
}

template <bool kOne>
int scan(const uint32_t* src, long long row_stride, long long col_stride,
         uint32_t* dst, uint32_t* scratch, long long n, long long cols,
         int run, long long nb, int run2, int reverse, int exclusive,
         int totals, const uint32_t* pows, const Modulus& M,
         cudaStream_t stream) {
  const ScanPows P = pows_from_words(pows);
  const int mode = totals ? kTotals : kFull;
  if (nb == 1)
    return (int)launch<kOne>(src, row_stride, col_stride, dst, nullptr, n,
                             1, cols, run, mode, reverse, exclusive, P, M,
                             stream);
  // pass 1: block totals; pass 2: their scan (one block a column) with
  // multiplier a^chunk; pass 3: the scan with each block's carry
  uint32_t* tot = scratch;
  cudaError_t err = launch<kOne>(src, row_stride, col_stride, tot, nullptr,
                                 n, nb, cols, run, kTotals, reverse, 0, P, M,
                                 stream);
  if (err != cudaSuccess) return (int)err;
  const ScanPows P2 = pows_from_words(pows + H2_LIMBS * (kLog + 1));
  if (totals)
    return (int)launch<kOne>(tot, H2_LIMBS, nb * H2_LIMBS, dst, nullptr, nb,
                             1, cols, run2,
                             kTotals, 0, 0, P2, M, stream);
  uint32_t* cry = scratch + cols * nb * H2_LIMBS;
  err = launch<kOne>(tot, H2_LIMBS, nb * H2_LIMBS, cry, nullptr, nb, 1, cols,
                     run2, kFull, 0, 1, P2, M, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch<kOne>(src, row_stride, col_stride, dst, cry, n, nb,
                           cols, run, kFull, reverse, exclusive, P, M,
                           stream);
}

}  // namespace

// src: element i of column c at c * col_stride + i * row_stride words,
// 16-byte aligned (strides multiples of 4); dst: (cols, n, 8) words, or (cols, 8) with
// totals; scratch: 2 * cols * nb * 8 words (nb > 1); run, nb, run2: the
// schedule (nb * 256 * run >= n, 256 * run2 >= nb); pows: 2 x 9 x 8
// words, Montgomery a and a^(run 2^k), then a^chunk and its powers for the
// carry pass (ignored when one != 0).  Returns cudaGetLastError().
extern "C" int h2_field_linscan(const void* src, long long row_stride,
                                long long col_stride, void* dst,
                                void* scratch, long long n, long long cols,
                                int run, long long nb, int run2, int reverse,
                                int exclusive, int totals, int one,
                                const uint32_t* pows, const uint32_t* mod,
                                void* stream) {
  const Modulus M = modulus_from_words(mod);
  if (n < 1 || cols < 1 || cols > 65535 || run < 1 || nb < 1 ||
      nb * kThreads * (long long)run < n ||
      (nb - 1) * kThreads * (long long)run >= n ||
      (nb > 1 && (long long)kThreads * run2 < nb))
    return (int)cudaErrorInvalidValue;
  auto s = (const uint32_t*)src;
  auto d = (uint32_t*)dst;
  auto w = (uint32_t*)scratch;
  const cudaStream_t st = (cudaStream_t)stream;
  return one ? scan<true>(s, row_stride, col_stride, d, w, n, cols, run, nb,
                          run2, reverse, exclusive, totals, pows, M, st)
             : scan<false>(s, row_stride, col_stride, d, w, n, cols, run, nb,
                           run2, reverse, exclusive, totals, pows, M, st);
}
