// Kernel: the scans along the rows of a vector or of each column of a
// stack, forward or reverse, writing every x_j, every x_(j-1) (exclusive)
// or only the last:
//   sum      x_j = v_j + x_(j-1)        (x_(-1) = 0)
//   linear   x_j = v_j + a x_(j-1) mod p, a constant a
//   product  x_j = r_j x_(j-1) mod p    (x_(-1) = 1, Montgomery form)
//
// Replaces, in one launch a call:
// - halo2tpu/fields/jfield.py::_prefix_sum_mod / suffix_sum_mod (sum):
//   Hillis-Steele rounds of masked adds;
// - halo2tpu/plonk/engine.py::_div_linear_jit: vec(X) / (X - a), there power
//   vectors of a and 1/a around a suffix sum; here the exclusive reverse
//   scan with multiplier a, out_i = sum_(j>i) vec_j a^(j-i-1), with no
//   power vector and no inversion;
// - halo2tpu/plonk/engine.py::_eval_group_jit: a stack of polys evaluated at
//   x, there a power vector, a product and a tree sum; here the reverse
//   scan's total with a = x (Horner's rule), one launch a group;
// - halo2tpu/fields/jfield.py::_prefix_prod and the prefix and suffix
//   products of batch_inv_scan (product), which the grand products
//   (halo2tpu/plonk/engine.py::_gp_chunk_jit) run in Hillis-Steele rounds
//   of masked Montgomery products.
// The port had run each as dozens of launches (a mont_mul or add a round),
// then as one to three (run folds, a scan of the block totals, a carry
// pass).
//
// Bound on the H100: the bytes (each element read once, written once) and,
// for the linear and product scans, one product an element (a serial scan's
// work); a parallel scan takes about two (a run's fold and its rescan).  At
// a proof's sizes (2^15 rows, one to 80 columns) a scan is microseconds of
// either, so a second or third launch cost as much as the work.  Design:
// one launch, single pass with decoupled look-back.  Logical positions q =
// j + pad, with pad identity elements (0, or 1 for the product) put before
// the first so that every block covers a whole chunk of 256 threads x `run`
// elements.  A block takes its logical index from an atomic ticket (so it
// only ever waits on blocks that are already running), a thread folds its
// run serially, and the block scans the 256 run totals in shared memory
// (Hillis-Steele, 8 rounds; the linear scan's round k multiplies by
// a^(run 2^k)).  It publishes its total (the aggregate), then its warp 0
// reads the status words of the 32 blocks before it: those that published
// their inclusive prefix end the walk at the last of them, and the values
// from there on are combined in order by shuffles (five rounds; the linear
// scan's round r multiplies the left half by A^(2^r), A = a^chunk), a
// window of 32 blocks at a time further back until an inclusive prefix is
// found.  The block then publishes its own inclusive prefix, and each thread
// folds its run again from its incoming value (the linear scan's thread t
// takes the block's prefix times a^(run t), 256 powers from the host),
// storing as it goes.  Field values are canonical, so any grouping of the
// combines gives the serial scan's bits.  A status word is epoch << 2 |
// status (1 aggregate, 2 inclusive), so the scratch is never cleared: each
// call that looks back takes a new epoch from the wrapper
// (ops/cuda_field.py::scan_shapes gives the schedule).
#include "field.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLog = 8;
constexpr int kLook = 5;            // a look-back window: 2^kLook blocks
constexpr long long kMaxSpins = 1LL << 28;   // reads of one status word

enum Kind : int { kSum = 0, kLinear = 1, kProduct = 2 };
enum : uint32_t { kAggregate = 1, kInclusive = 2 };

struct ScanPows {
  uint32_t a[H2_LIMBS];                   // the multiplier
  uint32_t step[kLog][H2_LIMBS];          // a^(run 2^k)
  uint32_t look[kLook + 1][H2_LIMBS];     // A^(2^r), A = a^(256 run)
};

// The look-back's global memory: a ticket counter, a status word and two
// values (the aggregate, then the inclusive prefix) a block and column.
struct Status {
  unsigned long long* tickets;
  uint32_t* flags;
  uint32_t* values;
};

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// a value another block published: past L1
__device__ __forceinline__ Fe fe_load_cg(const uint32_t* ptr) {
  const uint4 lo = __ldcg(reinterpret_cast<const uint4*>(ptr));
  const uint4 hi = __ldcg(reinterpret_cast<const uint4*>(ptr + 4));
  Fe r;
  r.v[0] = lo.x; r.v[1] = lo.y; r.v[2] = lo.z; r.v[3] = lo.w;
  r.v[4] = hi.x; r.v[5] = hi.y; r.v[6] = hi.z; r.v[7] = hi.w;
  return r;
}

__device__ __forceinline__ Fe fe_shfl_down(const Fe& a, int off) {
  Fe r;
#pragma unroll
  for (int i = 0; i < H2_LIMBS; i++)
    r.v[i] = __shfl_down_sync(0xFFFFFFFFu, a.v[i], off);
  return r;
}

template <int K>
__device__ __forceinline__ Fe identity(const Modulus& M) {
  return K == kProduct ? fe_const(M.one) : fe_zero();
}

// x_(j-1) -> x_j with v_j
template <int K>
__device__ __forceinline__ Fe fold(const Fe& x, const Fe& v, const Fe& a,
                                   const Modulus& M) {
  if (K == kSum) return fe_add(x, v, M);
  if (K == kLinear) return fe_add(fe_mul_inline(x, a, M), v, M);
  return fe_mul_inline(x, v, M);
}

// The scan of a left segment, then a right one: l carried over r's
// elements (the linear scan: l times a^(r's length), given as pw)
template <int K>
__device__ __forceinline__ Fe combine(const Fe& l, const Fe& r, const Fe& pw,
                                      const Modulus& M) {
  if (K == kSum) return fe_add(l, r, M);
  if (K == kLinear) return fe_add(fe_mul(l, pw, M), r, M);
  return fe_mul(l, r, M);
}

// One launch, nb blocks a column: element i of column c at src +
// c * col_stride + i * row_stride words.  totals: dst[c] = the column's
// last x; else dst (cols, n, 8), element i of column c.  lin_pows (256, 8):
// a^(run t) for the linear scan's rescan (full outputs, nb > 1), else unread.
template <int K>
__global__ void __launch_bounds__(kThreads, 2)
field_linscan_kernel(const uint32_t* __restrict__ src, long long row_stride,
                     long long col_stride, uint32_t* __restrict__ dst,
                     long long n, long long nb, int run, int totals,
                     int reverse, int exclusive,
                     const uint32_t* __restrict__ lin_pows, Status S,
                     unsigned long long ticket_base, uint32_t epoch,
                     const __grid_constant__ ScanPows P,
                     const __grid_constant__ Modulus M) {
  __shared__ uint32_t sh[H2_LIMBS][kThreads];
  __shared__ uint32_t prefix[H2_LIMBS];    // x before the block
  __shared__ long long ticket;
  const int t = threadIdx.x;
  long long lb = blockIdx.x;
  if (nb > 1) {
    if (t == 0) ticket = (long long)(atomicAdd(S.tickets, 1ull) - ticket_base);
    __syncthreads();
    lb = ticket;
  }
  const long long col = lb / nb, b = lb - col * nb;
  const long long chunk = (long long)kThreads * run;
  const long long first = b * chunk + (long long)t * run - (nb * chunk - n);
  const uint32_t* base = src + col * col_stride;
  const Fe a = fe_const(P.a);
  auto load = [&](long long j) {
    const long long i = reverse ? n - 1 - j : j;
    return fe_load(base + i * row_stride);
  };

  // the run's total (a padded element is the identity: skipped); each
  // element is loaded one step ahead, so its load overlaps the product
  const int s0 = first < 0 ? (int)(-first < run ? -first : run) : 0;
  Fe T = identity<K>(M);
  Fe v = s0 < run ? load(first + s0) : T;
  for (int s = s0; s < run; s++) {
    const Fe next = s + 1 < run ? load(first + s + 1) : v;
    T = s == s0 ? v : fold<K>(T, v, a, M);
    v = next;
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
      T = combine<K>(y, T, fe_const(P.step[k]), M);
    }
    __syncthreads();
  }
#pragma unroll
  for (int l = 0; l < H2_LIMBS; l++) sh[l][t] = T.v[l];
  __syncthreads();

  if (t < 32) {
    Fe total;
#pragma unroll
    for (int l = 0; l < H2_LIMBS; l++) total.v[l] = sh[l][kThreads - 1];
    const long long idx = col * nb + b;
    Fe E = identity<K>(M);
    if (b > 0) {
      if (t == 0) {
        fe_store(S.values + idx * 2 * H2_LIMBS, total);
        __threadfence();
        st_release(S.flags + idx, epoch << 2 | kAggregate);
      }
      // look back, 32 blocks at a time: lane l reads block end - 32 + l
      Fe mult = fe_zero();
      long long end = b;
      for (bool first_window = true;; first_window = false) {
        const long long j = end - 32 + t;
        uint32_t st = kInclusive;          // before the column: identity
        Fe x = identity<K>(M);
        if (j >= 0) {
          uint32_t w;
          long long spins = 0;
          do {
            w = ld_acquire(S.flags + col * nb + j);
            // a block before this one never publishes only on a fault:
            // end the launch with an error instead of hanging
            if (++spins > kMaxSpins) __trap();
          } while ((w >> 2) != epoch || (w & 3u) == 0);
          st = w & 3u;
          x = fe_load_cg(S.values +
                         ((col * nb + j) * 2 + (st == kInclusive)) * H2_LIMBS);
        }
        const unsigned inc = __ballot_sync(0xFFFFFFFFu, st == kInclusive);
        if (inc && t < 31 - __clz(inc)) x = identity<K>(M);
#pragma unroll
        for (int r = 0; r < kLook; r++) {
          const int off = 1 << r;
          const Fe y = fe_shfl_down(x, off);
          if ((t & (2 * off - 1)) == 0)
            x = combine<K>(x, y, fe_const(P.look[r]), M);
        }
        if (t == 0) {
          if (first_window) {
            E = x;
            if (K == kLinear) mult = fe_const(P.look[kLook]);
          } else {
            E = combine<K>(x, E, mult, M);
            if (K == kLinear) mult = fe_mul(mult, fe_const(P.look[kLook]), M);
          }
        }
        if (inc) break;
        end -= 32;
      }
    }
    if (t == 0) {
      const Fe incl = b > 0 ? combine<K>(E, total, fe_const(P.look[0]), M)
                            : total;
      if (b + 1 < nb) {
        fe_store(S.values + (idx * 2 + 1) * H2_LIMBS, incl);
        __threadfence();
        st_release(S.flags + idx, epoch << 2 | kInclusive);
      }
      if (totals && b + 1 == nb) fe_store(dst + col * H2_LIMBS, incl);
#pragma unroll
      for (int l = 0; l < H2_LIMBS; l++) prefix[l] = E.v[l];
    }
  }
  if (totals) return;
  __syncthreads();
  // x before this thread's run: the block's prefix carried over the runs
  // of threads 0 .. t-1
  Fe X;
#pragma unroll
  for (int l = 0; l < H2_LIMBS; l++) X.v[l] = prefix[l];
  if (t > 0) {
    Fe y;
#pragma unroll
    for (int l = 0; l < H2_LIMBS; l++) y.v[l] = sh[l][t - 1];
    X = b == 0 ? y
               : combine<K>(X, y,
                            K == kLinear ? fe_load(lin_pows + t * H2_LIMBS)
                                         : X,
                            M);
  }
  uint32_t* out = dst + col * n * H2_LIMBS;
  v = s0 < run ? load(first + s0) : X;
  for (int s = s0; s < run; s++) {
    const long long j = first + s;
    const long long i = reverse ? n - 1 - j : j;
    const Fe next = s + 1 < run ? load(j + 1) : v;
    if (exclusive) fe_store(out + i * H2_LIMBS, X);
    X = fold<K>(X, v, a, M);
    if (!exclusive) fe_store(out + i * H2_LIMBS, X);
    v = next;
  }
}

ScanPows pows_from_words(const uint32_t* w) {
  ScanPows P;
  for (int l = 0; l < H2_LIMBS; l++) P.a[l] = w[l];
  for (int k = 0; k < kLog; k++)
    for (int l = 0; l < H2_LIMBS; l++)
      P.step[k][l] = w[H2_LIMBS * (1 + k) + l];
  for (int r = 0; r <= kLook; r++)
    for (int l = 0; l < H2_LIMBS; l++)
      P.look[r][l] = w[H2_LIMBS * (1 + kLog + r) + l];
  return P;
}

template <int K>
cudaError_t launch(const uint32_t* src, long long row_stride,
                   long long col_stride, uint32_t* dst, long long n,
                   long long nb, long long cols, int run, int totals,
                   int reverse, int exclusive, const uint32_t* lin_pows,
                   const Status& S, unsigned long long ticket_base,
                   uint32_t epoch, const ScanPows& P, const Modulus& M,
                   cudaStream_t stream) {
  field_linscan_kernel<K><<<(unsigned)(nb * cols), kThreads, 0, stream>>>(
      src, row_stride, col_stride, dst, n, nb, run, totals, reverse,
      exclusive, lin_pows, S, ticket_base, epoch, P, M);
  return cudaGetLastError();
}

}  // namespace

// src: element i of column c at c * col_stride + i * row_stride words,
// 16-byte aligned (strides multiples of 4); dst: (cols, n, 8) words, or
// (cols, 8) with totals; kind: 0 sum, 1 linear, 2 product; run, nb: the
// schedule (nb * 256 * run >= n > (nb - 1) * 256 * run); pows: (1 + 8 + 6)
// x 8 words, Montgomery a, a^(run 2^k) and A^(2^r) (read for the linear
// scan only); lin_pows: device (256, 8) words a^(run t) (the linear scan
// with full outputs and nb > 1); tickets, flags, values: the look-back's
// scratch (nb > 1: a counter, cols * nb words, cols * nb * 16 words, 16-byte
// aligned), ticket_base the counter's value before this launch, epoch in
// [1, 2^30) not used by an earlier launch on this scratch since its flags
// were zeroed.  Returns cudaGetLastError().
extern "C" int h2_field_linscan(const void* src, long long row_stride,
                                long long col_stride, void* dst, long long n,
                                long long cols, int run, long long nb,
                                int reverse, int exclusive, int totals,
                                int kind, const uint32_t* pows,
                                const void* lin_pows, void* tickets,
                                void* flags, void* values,
                                unsigned long long ticket_base,
                                unsigned epoch, const uint32_t* mod,
                                void* stream) {
  const Modulus M = modulus_from_words(mod);
  if (n < 1 || cols < 1 || run < 1 || nb < 1 || kind < 0 || kind > 2 ||
      nb * cols > 0x7FFFFFFFLL || nb * kThreads * (long long)run < n ||
      (nb - 1) * kThreads * (long long)run >= n ||
      (nb > 1 && (epoch == 0 || epoch >= (1u << 30))) ||
      (kind == kLinear && nb > 1 && !totals && lin_pows == nullptr))
    return (int)cudaErrorInvalidValue;
  const ScanPows P = pows_from_words(pows);
  const Status S{(unsigned long long*)tickets, (uint32_t*)flags,
                 (uint32_t*)values};
  auto s = (const uint32_t*)src;
  auto d = (uint32_t*)dst;
  auto lp = (const uint32_t*)lin_pows;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case kSum:
      return (int)launch<kSum>(s, row_stride, col_stride, d, n, nb, cols,
                               run, totals, reverse, exclusive, lp, S,
                               ticket_base, epoch, P, M, st);
    case kLinear:
      return (int)launch<kLinear>(s, row_stride, col_stride, d, n, nb, cols,
                                  run, totals, reverse, exclusive, lp, S,
                                  ticket_base, epoch, P, M, st);
    default:
      return (int)launch<kProduct>(s, row_stride, col_stride, d, n, nb, cols,
                                   run, totals, reverse, exclusive, lp, S,
                                   ticket_base, epoch, P, M, st);
  }
}
