// Kernel: the radix-2 NTT over axis 0 of an (n, C, 8) Montgomery stack.
//
// Replaces halo2tpu/ops/ntt.py::_ntt_run and _intt_run: a Stockham loop of
// log2 n stages in XLA, each stage's butterfly products a Pallas multiply
// (halo2tpu/ops/pallas_field.py::_mont_mul_lane_tiled, through
// jfield.mont_mul once n >= 2^13), the adds and subtractions XLA ops, every
// stage a round trip of the whole stack through device memory.  The port
// had run the same loop as log2 n stages of separate torch launches.
//
// Bound on the H100: the operations.  A transform is (n / 2) log2 n
// Montgomery products a column (264 32-bit multiplies each) against 64
// bytes of traffic an element (read once, written once): at n = 2^15 about
// 31 products an element, so the integer multiply rate binds, as long as
// the stack crosses device memory only a few times.
//
// Design: a four-step split.  With n = n1 n2 and rows j = n2 j1 + j2,
// outputs k = k1 + n1 k2,
//   out[k] = sum_j2 omega^(j2 k1) omega_n2^(j2 k2) sum_j1 a[j] omega_n1^(j1 k1),
// so a transform is sub-transforms of n1 points (one per j2 and column),
// a twiddle multiply, then sub-transforms of n2 points (one per k1 and
// column).  n <= 2^10 takes one pass (n1 = n); larger n two passes, each
// sub-transform at most 2^10 points (n = 2^15: 2^8, then 2^7).  A pass sees
// its input as a matrix of L rows by W lines and transforms every line; a
// block holds a few whole lines in shared memory, loads them bit-reversed
// (consecutive threads on consecutive lines, so each row's load is one
// contiguous span), runs all log2 L radix-2 stages there (Cooley-Tukey,
// decimation in time, natural-order output), and writes each line's
// outputs once.  Fused into the same loads and stores: the per-row
// pre-scale of a coset transform (first pass), the twiddles between the
// passes (first of two), the 1 / n of the inverse and a per-row post-scale
// (last pass).  The first pass writes its outputs where the second reads
// its lines as matrix columns, and the second writes natural order: each
// pass reads the stack once and writes it once.
// Products and add/sub mod p are field.cuh's; every output is canonical, so
// the bits are those of the plain Stockham loop.
//
// Shared memory is [limb][position][line] (32 KB for 1,024 elements): a
// warp's threads touch consecutive words in the stages where they work on
// consecutive lines or positions.
#include "field.cuh"

namespace {

constexpr int kElemsPerBlock = 1024;  // elements of a block's lines
constexpr int kMaxThreads = 256;
constexpr long long kMinBlocks = 264;  // two an SM of the H100

struct NttPass {
  const uint32_t* in;     // L rows x `lines` lines of elements
  uint32_t* out;
  const uint32_t* tw;     // omega^t, t < n / 2 (Montgomery)
  const uint32_t* pre;    // per-row scale of the input (n, 8), or null
  const uint32_t* post;   // per-row scale of the output (n, 8), or null
  const uint32_t* scale;  // one element multiplying every output, or null
  long long lines;        // W
  long long cols;         // C: line g is column g % C of the stack
  long long group;        // S: output (k, g) goes to
                          //   (g / S) L S + k S + g % S
  int log_n;
  int log_l;              // L = 2^log_l points a line
  int log_lpb;            // 2^log_lpb lines a block
  int twiddle;            // output k of line g times omega^((g / C) k)
};

__device__ __forceinline__ Fe sm_get(const uint32_t* sm, int elems, int p) {
  Fe r;
#pragma unroll
  for (int i = 0; i < H2_LIMBS; i++) r.v[i] = sm[i * elems + p];
  return r;
}

__device__ __forceinline__ void sm_put(uint32_t* sm, int elems, int p,
                                       const Fe& a) {
#pragma unroll
  for (int i = 0; i < H2_LIMBS; i++) sm[i * elems + p] = a.v[i];
}

__global__ void __launch_bounds__(kMaxThreads)
    ntt_pass_kernel(const __grid_constant__ NttPass P,
                    const __grid_constant__ Modulus M) {
  extern __shared__ uint32_t sm[];
  const int lpb_mask = (1 << P.log_lpb) - 1;
  const int elems = 1 << (P.log_l + P.log_lpb);
  const long long g0 = (long long)blockIdx.x << P.log_lpb;
  const long long rows_per_line = P.lines / P.cols;  // W / C
  // load: element r of line g to position bitrev(r), pre-scaled by its row
  // of the stack, n2 r + g / C
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int r = e >> P.log_lpb, gl = e & lpb_mask;
    const long long g = g0 + gl;
    if (g >= P.lines) continue;
    Fe x = fe_load(P.in + ((long long)r * P.lines + g) * H2_LIMBS);
    if (P.pre != nullptr) {
      const long long row = r * rows_per_line + g / P.cols;
      x = fe_mul(x, fe_load(P.pre + row * H2_LIMBS), M);
    }
    const int p = (int)(__brev((unsigned)r) >> (32 - P.log_l));
    sm_put(sm, elems, (p << P.log_lpb) | gl, x);
  }
  __syncthreads();
  // stage s joins pairs (i, i + 2^(s-1)) of each block of 2^s positions
  // with the twiddle omega_L^(m L / 2^s) = omega^(m n / 2^s), m = i mod
  // 2^(s-1).  Lines past W compute on unset words and are never stored.
  for (int s = 1; s <= P.log_l; s++) {
    const int half = 1 << (s - 1);
    for (int b = threadIdx.x; b < (elems >> 1); b += blockDim.x) {
      const int gl = b & lpb_mask, bi = b >> P.log_lpb;
      const int m = bi & (half - 1);
      const int i = ((bi >> (s - 1)) << s) | m;
      const int pi = (i << P.log_lpb) | gl;
      const int pj = ((i + half) << P.log_lpb) | gl;
      const Fe u = sm_get(sm, elems, pi);
      const Fe w = fe_load(P.tw + ((long long)m << (P.log_n - s)) * H2_LIMBS);
      const Fe v = fe_mul(sm_get(sm, elems, pj), w, M);
      sm_put(sm, elems, pi, fe_add(u, v, M));
      sm_put(sm, elems, pj, fe_sub(u, v, M));
    }
    __syncthreads();
  }
  // store output k of line g, after the twiddle omega^((g / C) k) (first
  // pass of two: omega^t = -omega^(t - n/2) for t >= n / 2), 1 / n and the
  // post-scale of row k n1 + g / C
  const long long half_n = 1LL << (P.log_n - 1);
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int k = e >> P.log_lpb, gl = e & lpb_mask;
    const long long g = g0 + gl;
    if (g >= P.lines) continue;
    Fe x = sm_get(sm, elems, e);
    if (P.twiddle) {
      const long long t = (g / P.cols) * k;
      Fe w = fe_load(P.tw + (t & (half_n - 1)) * H2_LIMBS);
      if (t >= half_n) w = fe_sub(fe_zero(), w, M);
      x = fe_mul(x, w, M);
    }
    if (P.scale != nullptr) x = fe_mul(x, fe_load(P.scale), M);
    if (P.post != nullptr) {
      const long long row = k * rows_per_line + g / P.cols;
      x = fe_mul(x, fe_load(P.post + row * H2_LIMBS), M);
    }
    const long long o = (g / P.group) * (P.group << P.log_l) +
                        k * P.group + g % P.group;
    fe_store(P.out + o * H2_LIMBS, x);
  }
}

}  // namespace

// One pass of a transform over 2^log_n rows (see NttPass; the wrapper,
// ops/ntt.py, chooses the passes).  tw: the plan's omega^t, t < 2^(log_n
// - 1); pre / post / scale may be null.  Lines a block: as many as fill
// kElemsPerBlock, fewer while the grid would have under kMinBlocks blocks.
// mod: 17 words (p[8], inv, one[8]).  Returns cudaGetLastError().
extern "C" int h2_ntt_pass(const void* in, void* out, const void* tw,
                           const void* pre, const void* post,
                           const void* scale, long long lines, long long cols,
                           long long group, int twiddle, int log_n, int log_l,
                           const uint32_t* mod, void* stream) {
  const Modulus M = modulus_from_words(mod);
  if (log_l < 1 || log_l > log_n || (kElemsPerBlock >> log_l) < 1 ||
      cols < 1 || lines % cols != 0)
    return (int)cudaErrorInvalidValue;
  int log_lpb = 0;
  while ((2 << (log_l + log_lpb)) <= kElemsPerBlock) log_lpb++;
  while (log_lpb > 0 && ((lines + (1LL << log_lpb) - 1) >> log_lpb) <
                            kMinBlocks)
    log_lpb--;
  NttPass P;
  P.in = (const uint32_t*)in;
  P.out = (uint32_t*)out;
  P.tw = (const uint32_t*)tw;
  P.pre = (const uint32_t*)pre;
  P.post = (const uint32_t*)post;
  P.scale = (const uint32_t*)scale;
  P.lines = lines;
  P.cols = cols;
  P.group = group;
  P.log_n = log_n;
  P.log_l = log_l;
  P.log_lpb = log_lpb;
  P.twiddle = twiddle;
  const int elems = 1 << (log_l + log_lpb);
  int threads = elems / 2 < kMaxThreads ? elems / 2 : kMaxThreads;
  threads = (threads + 31) / 32 * 32;
  const long long blocks = (lines + (1LL << log_lpb) - 1) >> log_lpb;
  if (blocks > 0) {
    ntt_pass_kernel<<<(unsigned)blocks, threads,
                      (size_t)elems * H2_LIMBS * sizeof(uint32_t),
                      (cudaStream_t)stream>>>(P, M);
  }
  return (int)cudaGetLastError();
}
