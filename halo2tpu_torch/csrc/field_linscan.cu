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
// Two kernels: field_linscan_kernel takes the sum and the linear scan
// (ops/cuda_field.py::linscan), field_linscan_stream_kernel (below) the
// product scan (prodscan).  They share the decoupled look-back.
//
// field_linscan_kernel.  Bound on the H100: the bytes (each element read once,
// written once) and, for the linear scan, one product an element (a serial
// scan's work); a parallel scan takes about two (a run's fold and its rescan).
// At a proof's sizes (2^15 rows, one to 80 columns) a scan is microseconds of
// either, so a second or third launch cost as much as the work.  Design: one
// launch, single pass with decoupled look-back.  Logical positions q = j +
// pad, with pad zeros put before the first so that every block covers a whole
// chunk of 256 threads x `run` elements.  A block takes its logical index from
// an atomic ticket (so it only ever waits on blocks that are already running),
// a thread folds its run serially, and the block scans the 256 run totals in
// shared memory (Hillis-Steele, 8 rounds; the linear scan's round k multiplies
// by a^(run 2^k)).  It publishes its total (the aggregate), then its warp 0
// reads the status words of the 32 blocks before it: those that published
// their inclusive prefix end the walk at the last of them, and the values from
// there on are combined by shuffles (look_back; the linear scan's round r
// multiplies the left half by A^(2^r), A = a^chunk), a window of 32 blocks at
// a time further back until an inclusive prefix is found.  The block then
// publishes its own inclusive prefix, and each thread folds its run again from
// its incoming value (the linear scan's thread t takes the block's prefix
// times a^(run t), 256 powers from the host), storing as it goes.  Field
// values are canonical, so any grouping of the combines gives the serial
// scan's bits.  A status word is epoch << 2 | status (1 aggregate, 2
// inclusive), so the scratch is never cleared: each call that looks back takes
// a new epoch from the wrapper (ops/cuda_field.py::scan_shapes gives the
// schedule).
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

__device__ __forceinline__ Fe fe_shfl_up(const Fe& a, int off) {
  Fe r;
#pragma unroll
  for (int i = 0; i < H2_LIMBS; i++)
    r.v[i] = __shfl_up_sync(0xFFFFFFFFu, a.v[i], off);
  return r;
}

__device__ __forceinline__ Fe fe_shfl(const Fe& a, int src) {
  Fe r;
#pragma unroll
  for (int i = 0; i < H2_LIMBS; i++)
    r.v[i] = __shfl_sync(0xFFFFFFFFu, a.v[i], src);
  return r;
}

// A^(2^r), the look-back's round r multiplier: read for the linear scan
// only (look: A^(2^r) for r <= kLook, A the multiplier over a block)
template <int K>
__device__ __forceinline__ Fe look_pow(const uint32_t (*look)[H2_LIMBS],
                                       int r) {
  return K == kLinear ? fe_const(look[r]) : fe_zero();
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

// Warp 0 of block (or unit) b of column col, both kernels: publish the
// block's total (the aggregate), then walk back over the blocks before it,
// 32 at a time (lane l reads block end - 32 + l), until one that published
// its inclusive prefix; the values from the last inclusive prefix on are
// combined toward lane 31 in only as many rounds as there are such values
// (one block back: none); publish this block's inclusive prefix, and with
// totals the last block writes the column's total (look: look_pow's).
// Returns x before the block (all lanes).
template <int K>
__device__ __forceinline__ Fe look_back(const Fe& total, long long col,
                                        long long b, long long nb, int totals,
                                        const Status& S, uint32_t epoch,
                                        uint32_t* __restrict__ dst,
                                        const uint32_t (*look)[H2_LIMBS],
                                        const Modulus& M) {
  const int lane = threadIdx.x & 31;
  const Fe id = identity<K>(M);
  const long long idx = col * nb + b;
  Fe E = id;
  if (b > 0) {
    if (lane == 0) {
      fe_store(S.values + idx * 2 * H2_LIMBS, total);
      __threadfence();
      st_release(S.flags + idx, epoch << 2 | kAggregate);
    }
    Fe mult = fe_zero();
    long long end = b;
    for (bool first_window = true;; first_window = false) {
      const long long j = end - 32 + lane;
      uint32_t st = kInclusive;          // before the column: identity
      Fe v = id;
      if (j >= 0) {
        uint32_t word;
        long long spins = 0;
        do {
          word = ld_acquire(S.flags + col * nb + j);
          // a block before this one never publishes only on a fault: end
          // the launch with an error instead of hanging
          if (++spins > kMaxSpins) __trap();
        } while ((word >> 2) != epoch || (word & 3u) == 0);
        st = word & 3u;
        v = fe_load_cg(S.values +
                       ((col * nb + j) * 2 + (st == kInclusive)) * H2_LIMBS);
      }
      // the values from the last inclusive prefix on, combined toward lane
      // 31 in as many rounds as they need
      const unsigned inc = __ballot_sync(0xFFFFFFFFu, st == kInclusive);
      if (inc && lane < 31 - __clz(inc)) v = id;
      const int live = inc ? __clz(inc) + 1 : 32;
      for (int r = 0; (1 << r) < live; r++) {
        const Fe z = fe_shfl_up(v, 1 << r);
        if (((31 - lane) & ((2 << r) - 1)) == 0)
          v = combine<K>(z, v, look_pow<K>(look, r), M);
      }
      v = fe_shfl(v, 31);
      if (first_window) {
        E = v;
        mult = look_pow<K>(look, kLook);
      } else {
        E = combine<K>(v, E, mult, M);
        if (K == kLinear) mult = fe_mul(mult, look_pow<K>(look, kLook), M);
      }
      if (inc) break;
      end -= 32;
    }
  }
  if (lane == 0) {
    const Fe incl = b > 0 ? combine<K>(E, total, look_pow<K>(look, 0), M)
                          : total;
    if (b + 1 < nb) {
      fe_store(S.values + (idx * 2 + 1) * H2_LIMBS, incl);
      __threadfence();
      st_release(S.flags + idx, epoch << 2 | kInclusive);
    }
    if (totals && b + 1 == nb) fe_store(dst + col * H2_LIMBS, incl);
  }
  return E;
}

// One launch, nb blocks a column (K: kSum or kLinear): element i of column
// c at src + c * col_stride + i * row_stride words.  totals: dst[c] = the
// column's last x; else dst (cols, n, 8), element i of column c.
// lin_pows (256, 8): a^(run t) for the linear scan's rescan (full outputs,
// nb > 1), else unread.
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
    const Fe E = look_back<K>(total, col, b, nb, totals, S, epoch, dst,
                              P.look, M);
    if (t == 0) {
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
                                         : fe_zero(),
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


// -- field_linscan_stream_kernel --------------------------------------------
//
// The product scan x_j = r_j x_(j-1) mod p.  Bound on the H100: one
// product an element (a serial scan's work) and the bytes; a parallel scan
// takes about two products an element (a run's fold and its refold), so the
// product scans over dozens of columns are product-bound.  Design: one
// launch, single pass with decoupled look-back over units (blocks) of 128
// threads, each a chunk of 128 x `run` elements, thread t the run of
// elements t run .. t run + run - 1 (ops/cuda_field.py::stream_shapes picks
// the run and the units a column).  Logical positions q = j + pad, with pad
// ones put before the first so that every unit covers a whole chunk.
// - Each warp streams its 32 runs through a ring of kDepth tiles in shared
//   memory (cp.async, kDepth - 1 tiles in flight while it folds one): tile
//   k holds element k of every run, and its lanes copy consecutive 16-byte
//   words, so the copy of a tile is 32 pieces of 32 bytes; a thread's words
//   are padded by one so that a warp reading one element of each run hits
//   every bank once.  No chunk is held in shared memory.
// - Pass 1: a thread folds its run into the run's total.  The unit scans
//   the run totals by shuffles (five rounds in each warp, then warp 0 over
//   the four warp totals, between two barriers) and looks back for the
//   prefix before it.  Pass 2 streams the run again (from L2, mostly) and
//   folds it from the prefix before it, writing each output in place in
//   the tile, which the warp then stores coalesced.  A run of 32 costs
//   about 2 + 6 / 32 products an element.
// - One product chain a thread, few registers (kMinUnits units an SM) and
//   one inlined product in each pass: the product is about 560 SASS
//   instructions, so a kernel with many inlined copies runs out of the
//   instruction cache, and a product chain needs many warps beside it to
//   keep the integer pipe busy (measured: PERF.md, row 13a).
// - The look-back is field_linscan_kernel's (look_back), over units.
// The sum and the linear scan ran slower on it at a proof's single-column
// sizes (PERF.md, row 13), so they stay on field_linscan_kernel.

constexpr int kUnitThreads = 128;   // a unit: four warps
constexpr int kUnitWarps = kUnitThreads / 32;
constexpr int kDepth = 3;           // a warp's ring of tiles
constexpr int kMinUnits = 5;        // units an SM (at most 102 registers)
constexpr int kSlot = 3;            // 16-byte words a thread's tile: 2 + pad
constexpr int kTile = 32 * kSlot;   // 16-byte words a warp's tile
constexpr int kStreamMaxRun = 64;

// an element in shared memory: two 16-byte words
__device__ __forceinline__ Fe sh_load(const uint4* p) {
  const uint4 lo = p[0], hi = p[1];
  Fe r;
  r.v[0] = lo.x; r.v[1] = lo.y; r.v[2] = lo.z; r.v[3] = lo.w;
  r.v[4] = hi.x; r.v[5] = hi.y; r.v[6] = hi.z; r.v[7] = hi.w;
  return r;
}

__device__ __forceinline__ void sh_store(uint4* p, const Fe& a) {
  p[0] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  p[1] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// One launch, nb units a column: element i of column c at src + c *
// col_stride + i * row_stride words.  totals: dst[c] = the column's last x;
// else dst (cols, n, 8), element i of column c.  run: at most
// kStreamMaxRun.  Shared memory: each warp's ring, kDepth tiles of kTile
// 16-byte words.
__global__ void __launch_bounds__(kUnitThreads, kMinUnits)
field_linscan_stream_kernel(const uint32_t* __restrict__ src,
                            long long row_stride, long long col_stride,
                            uint32_t* __restrict__ dst, long long n,
                            long long nb, int run, int totals, int reverse,
                            int exclusive, Status S,
                            unsigned long long ticket_base, uint32_t epoch,
                            const __grid_constant__ Modulus M) {
  __shared__ uint4 ring_sh[kUnitWarps * kDepth * kTile];
  __shared__ uint32_t warp_sh[kUnitWarps][H2_LIMBS];   // warp totals, x
  __shared__ uint4 xe_sh[kUnitThreads][2];   // x over the runs before
  __shared__ long long ticket;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  long long lb = blockIdx.x;
  if (nb > 1) {
    if (t == 0) ticket = (long long)(atomicAdd(S.tickets, 1ull) - ticket_base);
    __syncthreads();
    lb = ticket;
  }
  const long long col = lb / nb, b = lb - col * nb;
  const long long chunk = (long long)kUnitThreads * run;
  const uint32_t* base = src + col * col_stride;
  uint32_t* out = dst + col * n * H2_LIMBS;
  const Fe one = fe_const(M.one);
  // j of the warp's first element
  const long long q0 = b * chunk - (nb * chunk - n) + 32LL * run * w;
  uint4* ring = ring_sh + w * kDepth * kTile;

  // word u of a warp's tile k: thread u / 2's element k, 16-byte half u & 1;
  // in shared memory at u + u / 2 (one pad a thread)
  auto row_of = [&](int k, int u) {
    return q0 + (long long)(u >> 1) * run + k;   // j
  };
  auto load_tile = [&](int k) {
    uint4* tile = ring + (k % kDepth) * kTile;
#pragma unroll
    for (int it = 0; it < 2; it++) {
      const int u = it * 32 + lane, h = u & 1;
      uint4* slot = tile + u + (u >> 1);
      const long long j = row_of(k, u);
      if (j < 0) {
        *slot = h ? make_uint4(one.v[4], one.v[5], one.v[6], one.v[7])
                  : make_uint4(one.v[0], one.v[1], one.v[2], one.v[3]);
      } else {
        const long long i = reverse ? n - 1 - j : j;
        cp_async16(slot, base + i * row_stride + 4 * h);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  // wait for tile k (tiles up to k + kDepth - 2 loading), then the warp sees
  // every lane's copy and has left tile k - 1
  auto wait_tile = [&](int k) {
    if (k + 1 < run)
      asm volatile("cp.async.wait_group %0;" ::"n"(kDepth - 2) : "memory");
    else
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncwarp();
  };
  // pass 1: the run, folded (its first element is its first x)
  for (int k = 0; k < kDepth - 1 && k < run; k++) load_tile(k);
  wait_tile(0);
  if (kDepth - 1 < run) load_tile(kDepth - 1);
  Fe x = sh_load(ring + lane * kSlot);
  for (int k = 1; k < run; k++) {
    wait_tile(k);
    if (k + kDepth - 1 < run) load_tile(k + kDepth - 1);
    x = fe_mul_inline(x, sh_load(ring + (k % kDepth) * kTile + lane * kSlot),
                      M);
  }
  __syncwarp();
  // pass 2's first tiles load during the unit's scan
  if (!totals)
    for (int k = 0; k < kDepth - 1 && k < run; k++) load_tile(k);

  // inclusive scan of the run totals in each warp, then warp 0 over the
  // warp totals; it looks back and leaves x before each warp in warp_sh
#pragma unroll
  for (int k = 0; k < 5; k++) {
    const Fe y = fe_shfl_up(x, 1 << k);
    if (lane >= (1 << k)) x = fe_mul(y, x, M);
  }
  // the runs before this one, kept in shared memory over the look-back
  sh_store(xe_sh[t], fe_shfl_up(x, 1));
  if (lane == 31) {
#pragma unroll
    for (int l = 0; l < H2_LIMBS; l++) warp_sh[w][l] = x.v[l];
  }
  __syncthreads();
  if (w == 0) {
    Fe y = one;
    if (lane < kUnitWarps) {
#pragma unroll
      for (int l = 0; l < H2_LIMBS; l++) y.v[l] = warp_sh[lane][l];
    }
#pragma unroll
    for (int k = 0; (1 << k) < kUnitWarps; k++) {
      const Fe z = fe_shfl_up(y, 1 << k);
      if (lane >= (1 << k) && lane < kUnitWarps) y = fe_mul(z, y, M);
    }
    const Fe wex = fe_shfl_up(y, 1);              // the warps before
    const Fe E = look_back<kProduct>(fe_shfl(y, kUnitWarps - 1), col, b, nb,
                                     totals, S, epoch, dst, nullptr, M);
    if (!totals && lane < kUnitWarps) {
      const Fe wp = lane == 0 ? E : b == 0 ? wex : fe_mul(E, wex, M);
#pragma unroll
      for (int l = 0; l < H2_LIMBS; l++) warp_sh[lane][l] = wp.v[l];
    }
  }
  if (totals) return;
  __syncthreads();

  // x before this thread's run
  Fe X;
#pragma unroll
  for (int l = 0; l < H2_LIMBS; l++) X.v[l] = warp_sh[w][l];
  if (lane > 0) {
    const Fe xe = sh_load(xe_sh[t]);
    X = (b == 0 && w == 0) ? xe : fe_mul(X, xe, M);
  }

  // pass 2: each output in place in its tile, then the tile stored
  for (int k = 0; k < run; k++) {
    wait_tile(k);
    if (k + kDepth - 1 < run) load_tile(k + kDepth - 1);
    uint4* tile = ring + (k % kDepth) * kTile;
    uint4* mine = tile + lane * kSlot;
    const Fe v = sh_load(mine);
    if (exclusive) sh_store(mine, X);
    X = fe_mul_inline(X, v, M);
    if (!exclusive) sh_store(mine, X);
    __syncwarp();
#pragma unroll
    for (int it = 0; it < 2; it++) {
      const int u = it * 32 + lane;
      const long long j = row_of(k, u);
      if (j < 0) continue;
      const long long i = reverse ? n - 1 - j : j;
      reinterpret_cast<uint4*>(out + i * H2_LIMBS)[u & 1] =
          tile[u + (u >> 1)];
    }
  }
}

}  // namespace

// src: element i of column c at c * col_stride + i * row_stride words,
// 16-byte aligned (strides multiples of 4); dst: (cols, n, 8) words, or
// (cols, 8) with totals; kind: 0 sum, 1 linear; run, nb: the schedule (nb
// * 256 * run >= n > (nb - 1) * 256 * run); pows: (1 + 8 + 6) x 8 words,
// Montgomery a, a^(run 2^k) and A^(2^r) (read for the linear scan only);
// lin_pows: device (256, 8) words a^(run t) (the linear scan with full
// outputs and nb > 1); tickets, flags, values: the look-back's scratch (nb
// > 1: a counter, cols * nb words, cols * nb * 16 words, 16-byte aligned),
// ticket_base the counter's value before this launch, epoch in [1, 2^30)
// not used by an earlier launch on this scratch since its flags were
// zeroed.  Returns cudaGetLastError().
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
  if (n < 1 || cols < 1 || run < 1 || nb < 1 || kind < 0 || kind > 1 ||
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
  if (kind == kSum)
    return (int)launch<kSum>(s, row_stride, col_stride, d, n, nb, cols, run,
                             totals, reverse, exclusive, lp, S, ticket_base,
                             epoch, P, M, st);
  return (int)launch<kLinear>(s, row_stride, col_stride, d, n, nb, cols, run,
                              totals, reverse, exclusive, lp, S, ticket_base,
                              epoch, P, M, st);
}

// The product scan (field_linscan_stream_kernel).  src, dst, the look-back's
// scratch, ticket_base and epoch as h2_field_linscan's; run, nb: the
// schedule (2 <= run <= 64, nb * 128 run >= n > (nb - 1) * 128 run).
// Returns cudaGetLastError().
extern "C" int h2_field_linscan_stream(const void* src, long long row_stride,
                                       long long col_stride, void* dst,
                                       long long n, long long cols, int run,
                                       long long nb, int reverse,
                                       int exclusive, int totals,
                                       void* tickets, void* flags,
                                       void* values,
                                       unsigned long long ticket_base,
                                       unsigned epoch, const uint32_t* mod,
                                       void* stream) {
  const Modulus M = modulus_from_words(mod);
  const long long chunk = (long long)kUnitThreads * run;
  if (n < 1 || cols < 1 || run < 2 || run > kStreamMaxRun || nb < 1 ||
      nb * cols > 0x7FFFFFFFLL || nb * chunk < n || (nb - 1) * chunk >= n ||
      (nb > 1 && (epoch == 0 || epoch >= (1u << 30))))
    return (int)cudaErrorInvalidValue;
  const Status S{(unsigned long long*)tickets, (uint32_t*)flags,
                 (uint32_t*)values};
  field_linscan_stream_kernel<<<(unsigned)(nb * cols), kUnitThreads, 0,
                                (cudaStream_t)stream>>>(
      (const uint32_t*)src, row_stride, col_stride, (uint32_t*)dst, n, nb,
      run, totals, reverse, exclusive, S, ticket_base, epoch, M);
  return (int)cudaGetLastError();
}
