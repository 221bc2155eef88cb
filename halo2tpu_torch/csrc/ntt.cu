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
// its input as a matrix of L rows by W lines and transforms every line
// (Cooley-Tukey, decimation in time: bit-reversed input positions,
// natural-order output); a block takes 2^log_lpb whole lines, at most
// kElemsPerBlock elements.  Fused into the same loads and stores: the
// per-row pre-scale of a coset transform (first pass), the twiddles between
// the passes (first of two), the 1 / n of the inverse and a per-row
// post-scale (last pass).  The first pass writes its outputs where the
// second reads its lines as matrix columns, and the second writes natural
// order: each pass reads the stack once and writes it once.
//
// Inside a pass a block's elements are numbered e = position * 2^log_lpb +
// line.  The log2 L stages run in rounds of up to RB: in a round each
// thread holds the 2^RB elements whose numbers differ in RB neighbouring
// bits [lo, lo + RB) of e, and runs the round's stages (pairs differing in
// one of those bits) in registers.  RB = 3 (eight elements, four
// butterflies a stage) where a pass has at least kWideElems elements; a
// smaller pass (one column: 128 or 256 lines) takes RB = 1, so that its
// few lines still give each SM several warps.  The first round loads its
// elements straight from device memory, the last stores them there;
// between rounds they cross shared memory once (a 256-point line at RB =
// 3: 2 exchanges and 3 barriers where one stage a barrier took 8).  The L /
// 2 stage twiddles omega_L^u are copied into shared memory once a block
// (cp.async, beside the first round's loads).  A butterfly whose twiddle is
// 1 (m = 0: every one of the first stage, half of the second, ...) adds and
// subtracts without the product, as does the between-pass twiddle at t =
// 0: a Montgomery product by one returns its canonical input, so the bits
// do not change.  The products are field.cuh's out-of-line fe_mul: with a
// copy of its body at each butterfly the kernel's code grew several-fold
// and ran slower on the H100.  Add/sub mod p are
// field.cuh's; every output is canonical, so the bits are those of the
// plain Stockham loop.  ops/ntt.py::reg_bits and lines_per_block choose RB
// and log_lpb as the launch below does, and tests/test_torch_ntt_fused.py
// writes this schedule out in torch.
//
// Shared memory: each element as two 16-byte halves, [half][e], then the
// stage twiddles [half][u]: at most 1,536 elements, 48 KB.  At RB = 3
// neighbouring threads take neighbouring e in every exchange (lo >= 3
// there), so a quarter warp's 16-byte accesses fall on distinct banks.
#include "field.cuh"

namespace {

constexpr int kElemsPerBlock = 1024;          // elements of a block's lines
constexpr long long kMinBlocks = 264;         // two an SM of the H100
// a pass of at least this many elements gives each thread 2^3 of them in
// registers; a smaller one 2^1, so that its few lines still fill warps
constexpr long long kWideElems = 1LL << 19;

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ Fe sm_get(const uint4* buf, int stride, int i) {
  const uint4 lo = buf[i];
  const uint4 hi = buf[stride + i];
  Fe r;
  r.v[0] = lo.x; r.v[1] = lo.y; r.v[2] = lo.z; r.v[3] = lo.w;
  r.v[4] = hi.x; r.v[5] = hi.y; r.v[6] = hi.z; r.v[7] = hi.w;
  return r;
}

__device__ __forceinline__ void sm_put(uint4* buf, int stride, int i,
                                       const Fe& a) {
  buf[i] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  buf[stride + i] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
}

// The first of a round's 2^RB element numbers: group q with RB zero bits
// inserted at lo.
template <int RB>
__device__ __forceinline__ int group_base(int q, int lo) {
  return (q & ((1 << lo) - 1)) | ((q >> lo) << (lo + RB));
}

// RB = 3: 128 threads, 4 blocks an SM; RB = 1: up to 512 threads.  Both at
// most 128 registers a thread.
template <int RB>
__global__ void __launch_bounds__(kElemsPerBlock >> RB, 4 >> (3 - RB))
    ntt_pass_kernel(const __grid_constant__ NttPass P,
                    const __grid_constant__ Modulus M) {
  constexpr int kRegs = 1 << RB;
  extern __shared__ uint4 sm[];
  const int log_l = P.log_l, log_lpb = P.log_lpb;
  const int elems = 1 << (log_l + log_lpb);
  const int half_l = 1 << (log_l - 1);
  uint4* el = sm;                 // [2][elems]
  uint4* twl = sm + 2 * elems;    // [2][half_l]: omega^(u n / L)
  const int lpb_mask = (1 << log_lpb) - 1;
  const long long g0 = (long long)blockIdx.x << log_lpb;
  const long long rows_per_line = P.lines / P.cols;   // W / C
  const int q = threadIdx.x;      // one group of 2^RB a round
  for (int u = q; u < half_l; u += blockDim.x) {
    const uint32_t* w = P.tw + ((long long)u << (P.log_n - log_l)) *
                                   H2_LIMBS;
    cp_async16(&twl[u], w);
    cp_async16(&twl[half_l + u], w + 4);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");

  Fe x[kRegs];
  const int rounds = (log_l + RB - 1) / RB;
#pragma unroll 1
  for (int round = 0; round < rounds; round++) {
    const int s0 = round * RB;    // stages s0 + 1 .. s0 + r
    const int r = min(RB, log_l - s0);
    const int lo = min(log_lpb + s0, log_lpb + log_l - RB);
    const int base = group_base<RB>(q, lo);
    if (round == 0) {
      // element r of line g to position bitrev(r), pre-scaled by its row
      // of the stack, n2 r + g / C
#pragma unroll
      for (int j = 0; j < kRegs; j++) {
        const int e = base | (j << lo);
        const long long g = g0 + (e & lpb_mask);
        const int row = (int)(__brev((unsigned)(e >> log_lpb)) >>
                              (32 - log_l));
        if (g < P.lines) {
          x[j] = fe_load(P.in + ((long long)row * P.lines + g) * H2_LIMBS);
          if (P.pre != nullptr) {
            const long long pr = row * rows_per_line + g / P.cols;
            x[j] = fe_mul(x[j], fe_load(P.pre + pr * H2_LIMBS), M);
          }
        } else {
          x[j] = fe_zero();       // a line past W: computed, never stored
        }
      }
      asm volatile("cp.async.wait_all;" ::: "memory");
      __syncthreads();
    } else {
#pragma unroll
      for (int j = 0; j < kRegs; j++)
        x[j] = sm_get(el, elems, base | (j << lo));
    }
    // stage s joins positions i and i + 2^(s-1) (position bit s - 1, e's
    // bit log_lpb + s - 1, this thread's register bit jb) with the twiddle
    // omega_(2^s)^m = twl[m << (log_l - s)], m = i mod 2^(s-1)
#pragma unroll
    for (int jb = 0; jb < RB; jb++) {
      if (jb < RB - r) continue;
      const int s = lo + jb - log_lpb + 1;
      const int m_mask = (1 << (s - 1)) - 1;
#pragma unroll
      for (int j = 0; j < kRegs; j++) {
        if (j & (1 << jb)) continue;
        const int jj = j | (1 << jb);
        const int m = ((base | (j << lo)) >> log_lpb) & m_mask;
        Fe v = x[jj];
        if (m != 0) {
          v = fe_mul(v, sm_get(twl, half_l, m << (log_l - s)), M);
        }
        const Fe u = x[j];
        x[j] = fe_add(u, v, M);
        x[jj] = fe_sub(u, v, M);
      }
    }
    if (round + 1 < rounds) {
#pragma unroll
      for (int j = 0; j < kRegs; j++)
        sm_put(el, elems, base | (j << lo), x[j]);
      __syncthreads();
      continue;
    }
    // store output k of line g, after the twiddle omega^((g / C) k) (first
    // pass of two: omega^t = -omega^(t - n/2) for t >= n / 2; none at t =
    // 0), 1 / n and the post-scale of row k n1 + g / C
    const long long half_n = 1LL << (P.log_n - 1);
#pragma unroll
    for (int j = 0; j < kRegs; j++) {
      const int e = base | (j << lo);
      const long long g = g0 + (e & lpb_mask);
      const int k = e >> log_lpb;
      if (g >= P.lines) continue;
      Fe y = x[j];
      if (P.twiddle) {
        const long long t = (g / P.cols) * k;
        if (t != 0) {
          Fe w = fe_load(P.tw + (t & (half_n - 1)) * H2_LIMBS);
          if (t >= half_n) w = fe_sub(fe_zero(), w, M);
          y = fe_mul(y, w, M);
        }
      }
      if (P.scale != nullptr) y = fe_mul(y, fe_load(P.scale), M);
      if (P.post != nullptr) {
        const long long row = k * rows_per_line + g / P.cols;
        y = fe_mul(y, fe_load(P.post + row * H2_LIMBS), M);
      }
      const long long o = (g / P.group) * (P.group << log_l) +
                          (long long)k * P.group + g % P.group;
      fe_store(P.out + o * H2_LIMBS, y);
    }
  }
}

}  // namespace

// One pass of a transform over 2^log_n rows (see NttPass; the wrapper,
// ops/ntt.py, chooses the passes).  tw: the plan's omega^t, t < 2^(log_n
// - 1); pre / post / scale may be null.  Register bits RB and lines a
// block (ops/ntt.py::reg_bits, lines_per_block): RB = 3 from kWideElems
// elements on, else 1; as many lines as fill kElemsPerBlock, fewer while
// the grid would have under kMinBlocks blocks, but at least 2^RB elements
// (one thread's registers).  mod: 17 words (p[8], inv, one[8]).  Returns
// cudaGetLastError().
extern "C" int h2_ntt_pass(const void* in, void* out, const void* tw,
                           const void* pre, const void* post,
                           const void* scale, long long lines, long long cols,
                           long long group, int twiddle, int log_n, int log_l,
                           const uint32_t* mod, void* stream) {
  const Modulus M = modulus_from_words(mod);
  if (log_l < 1 || log_l > log_n || (kElemsPerBlock >> log_l) < 1 ||
      cols < 1 || lines % cols != 0)
    return (int)cudaErrorInvalidValue;
  const int rb = (lines << log_l) >= kWideElems ? 3 : 1;
  int log_lpb = 0;
  while ((2 << (log_l + log_lpb)) <= kElemsPerBlock) log_lpb++;
  while (log_lpb > 0 && ((lines + (1LL << log_lpb) - 1) >> log_lpb) <
                            kMinBlocks)
    log_lpb--;
  if (log_l + log_lpb < rb) log_lpb = rb - log_l;
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
  const size_t smem = (size_t)(2 * elems + (1 << log_l)) * sizeof(uint4);
  const long long blocks = (lines + (1LL << log_lpb) - 1) >> log_lpb;
  if (blocks > 0) {
    const auto kernel = rb == 3 ? ntt_pass_kernel<3> : ntt_pass_kernel<1>;
    kernel<<<(unsigned)blocks, elems >> rb, smem, (cudaStream_t)stream>>>(
        P, M);
  }
  return (int)cudaGetLastError();
}
