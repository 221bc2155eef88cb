// Kernel: a field program over rows, split into G sub-programs, one warp a
// sub-program, 32 rows a block.
//
// Replaces the quotient's per-part evaluation, halo2tpu/plonk/quotient.py::
// _fold_part_jnp: there XLA fuses each gate's adds, subtractions and
// negations around the Montgomery products, which reach the Pallas
// multiply (halo2tpu/ops/pallas_field.py::_mont_mul_lane_tiled), and the
// rule values are folded by y in a weighted reduction.  Here
// plonk/quotient.py compiles everything a part computes (every gate poly,
// the permutation and lookup rules, the theta-compressions, the Horner
// y-fold and the final 1 / Z_H scale) into one program, and one launch runs
// it for every row.  The engine's weighted sums (sum_i c_i v_i) are small
// programs of the same kind.
//
// A program is G sub-programs of int4 instructions (op, dst, a, b) over
// slots:
//   LOAD   dst, leaf, rot   slot[dst] = leaf[(row + rot) mod n], rot in [0, n)
//   CONST  dst, k           slot[dst] = consts[k]
//   ADD / SUB / MUL dst, a, b;  NEG / SQR dst, a
//   HORNER acc, v, k        slot[acc] = slot[acc] * consts[k] + slot[v]
//   OUT    -, a             this sub-program's result = slot[a] (the kernel
//                           copies it to the warp's slot 0)
// and a combine: out[row] = (sum_g res_g * consts[comb[g]]) * consts[scale]
// (comb[g] < 0 or scale < 0: no product).  The compiler cuts a part's
// values into G contiguous groups of about equal cost, each folded by y
// into its own accumulator; comb[g] is y^(values after group g), so the
// sum is the Horner fold of the whole sequence, and the field arithmetic
// is exact and canonical, so the bits are those of one program.
//
// Instructions are read from device memory (a program is thousands of
// instructions long, beyond constant memory): every thread of a warp reads
// the same word, a broadcast that stays in L1, so the branch on the opcode
// is uniform within a warp and nothing diverges.  Leaves are (pointer, row
// stride) pairs, so strided column views need no copy.  Each warp's slots
// live in shared memory laid out [warp][slot][limb][lane]: 32 lanes touch
// 32 consecutive words, with no bank conflict.  After one __syncthreads
// warp 0 combines the G results (each warp's slot 0), scales and stores.
//
// Bound on the H100: the operations, 32-bit integer multiplies (the
// RSA-SHA256 part takes about 1,500 Montgomery products a row), unless the
// program reads many leaves and multiplies little (a weighted sum: then
// the bytes).  One thread a row gave 2^15 rows as 1,024 warps, 7.75 an SM,
// too few to hide the carry chains' latency (5.3-5.6x the bound).  With G
// warps on a row the card holds G times as many: ops/field_prog.py::
// groups_for picks G so that rows * G / 32 warps fill about 32 warps an SM
// (G = 4 at 2^15 rows).  The registers cap it there: at 64 a thread an SM
// holds 8 blocks of 4 warps, 32 warps, and 1,024 blocks are one wave, so
// more sub-programs or more rows a launch add no resident warp (capped at
// 48 registers, ptxas spilled 160 bytes and the kernel ran no faster).  A
// leaf is loaded where a sub-program uses it (the RSA part loads 2,030
// times from 487 leaves a row), so the loads are several times the bytes
// bound; the split adds none.
#include "field.cuh"

namespace {

constexpr int kRows = 32;         // rows a block: one a lane of each warp
constexpr int kMaxGroups = 8;     // warps a block at most (G_MAX)
constexpr int kSlotWords = H2_LIMBS * kRows;

enum Op : int {
  kLoad = 0, kConst = 1, kAdd = 2, kSub = 3, kNeg = 4, kMul = 5, kSqr = 6,
  kHorner = 7, kOut = 8
};

struct Leaf {
  long long ptr;     // device address of row 0
  long long stride;  // 32-bit words from one row to the next
};

__device__ __forceinline__ Fe slot_get(const uint32_t* slots, int s) {
  const uint32_t* p = slots + s * kSlotWords + (threadIdx.x & 31);
  Fe r;
#pragma unroll
  for (int l = 0; l < H2_LIMBS; l++) r.v[l] = p[l * kRows];
  return r;
}

__device__ __forceinline__ void slot_put(uint32_t* slots, int s,
                                         const Fe& a) {
  uint32_t* p = slots + s * kSlotWords + (threadIdx.x & 31);
#pragma unroll
  for (int l = 0; l < H2_LIMBS; l++) p[l * kRows] = a.v[l];
}

// meta: starts[0..G] (sub-program g is prog[starts[g], starts[g + 1])),
// then comb[0..G-1].
__global__ void __launch_bounds__(kMaxGroups * kRows)
field_prog_kernel(const int4* __restrict__ prog, const int* __restrict__ meta,
                  int groups, int scale, int slots_per_warp,
                  const Leaf* __restrict__ leaves,
                  const uint32_t* __restrict__ consts,
                  uint32_t* __restrict__ out, long long n,
                  const __grid_constant__ Modulus M) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  uint32_t* slots = smem + warp * slots_per_warp * kSlotWords;
  const long long row = blockIdx.x * (long long)kRows + (threadIdx.x & 31);
  if (row < n) {
    const int end = __ldg(meta + warp + 1);
    int pc = __ldg(meta + warp);
    int4 ins = __ldg(prog + pc);
    for (; pc < end; pc++) {
      const int4 next = __ldg(prog + (pc + 1 < end ? pc + 1 : pc));
      switch (ins.x) {
        case kLoad: {
          const Leaf leaf = leaves[ins.z];
          long long r = row + ins.w;
          if (r >= n) r -= n;
          const uint32_t* base = reinterpret_cast<const uint32_t*>(leaf.ptr);
          slot_put(slots, ins.y, fe_load(base + r * leaf.stride));
          break;
        }
        case kConst:
          slot_put(slots, ins.y, fe_load(consts + ins.z * H2_LIMBS));
          break;
        case kAdd:
          slot_put(slots, ins.y, fe_add(slot_get(slots, ins.z),
                                        slot_get(slots, ins.w), M));
          break;
        case kSub:
          slot_put(slots, ins.y, fe_sub(slot_get(slots, ins.z),
                                        slot_get(slots, ins.w), M));
          break;
        case kNeg:
          slot_put(slots, ins.y,
                   fe_sub(fe_zero(), slot_get(slots, ins.z), M));
          break;
        case kMul:
          slot_put(slots, ins.y, fe_mul(slot_get(slots, ins.z),
                                        slot_get(slots, ins.w), M));
          break;
        case kSqr:
          slot_put(slots, ins.y, fe_sqr(slot_get(slots, ins.z), M));
          break;
        case kHorner: {
          const Fe c = fe_load(consts + ins.w * H2_LIMBS);
          const Fe t = fe_mul(slot_get(slots, ins.y), c, M);
          slot_put(slots, ins.y, fe_add(t, slot_get(slots, ins.z), M));
          break;
        }
        default:  // kOut
          if (ins.z != 0) slot_put(slots, 0, slot_get(slots, ins.z));
          break;
      }
      ins = next;
    }
  }
  __syncthreads();
  if (warp != 0 || row >= n) return;
  Fe acc = fe_zero();
  for (int g = 0; g < groups; g++) {
    Fe r = slot_get(smem + g * slots_per_warp * kSlotWords, 0);
    const int k = __ldg(meta + groups + 1 + g);
    if (k >= 0) r = fe_mul(r, fe_load(consts + k * H2_LIMBS), M);
    acc = g == 0 ? r : fe_add(acc, r, M);
  }
  if (scale >= 0) acc = fe_mul(acc, fe_load(consts + scale * H2_LIMBS), M);
  fe_store(out + row * H2_LIMBS, acc);
}

}  // namespace

// prog: the sub-programs' int4 instructions, back to back; meta: 2G + 1
// ints (starts, then comb) on the device; scale: a constant index or -1;
// slots: the most any sub-program uses; leaves: (pointer, row stride)
// pairs of int64; consts: (K, 8) words; out: (n, 8) words.  Shared memory:
// G * slots KB a block of 32 G threads.  Every pointer 16-byte
// aligned, every leaf stride a multiple of 4 words.  Returns
// cudaGetLastError().
extern "C" int h2_field_prog(const void* prog, const void* meta, int groups,
                             int scale, const void* leaves,
                             const void* consts, void* out, long long n,
                             int slots, const uint32_t* mod, void* stream) {
  const Modulus M = modulus_from_words(mod);
  if (groups < 1 || groups > kMaxGroups || slots < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)groups * slots * kSlotWords * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        field_prog_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (n > 0) {
    const long long blocks = (n + kRows - 1) / kRows;
    field_prog_kernel<<<(unsigned)blocks, groups * kRows, smem,
                        (cudaStream_t)stream>>>(
        (const int4*)prog, (const int*)meta, groups, scale, slots,
        (const Leaf*)leaves, (const uint32_t*)consts, (uint32_t*)out, n, M);
  }
  return (int)cudaGetLastError();
}
