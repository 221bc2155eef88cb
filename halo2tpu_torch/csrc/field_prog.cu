// Kernel: a field program over rows, one thread a row.
//
// Replaces the quotient's per-part evaluation, halo2tpu/plonk/quotient.py::
// _fold_part_jnp: there XLA fuses each gate's adds, subtractions and
// negations around the Montgomery products, which reach the Pallas
// multiply (halo2tpu/ops/pallas_field.py::_mont_mul_lane_tiled), and the
// rule values are folded by y in a weighted reduction.  The port had run
// the same part as about a thousand separate field operations, each one
// mont_mul launch or a dozen torch launches, every intermediate a round
// trip through device memory.  Here plonk/quotient.py compiles everything a
// part computes (every gate poly, the permutation and lookup rules, the
// theta-compressions, the Horner y-fold and the final 1 / Z_H scale) into
// one flat program, and one launch runs it for every row.
//
// The program is a list of int4 instructions (op, dst, a, b) over slots:
//   LOAD   dst, leaf, rot   slot[dst] = leaf[(row + rot) mod n], rot in [0, n)
//   CONST  dst, k           slot[dst] = consts[k]
//   ADD / SUB / MUL dst, a, b;  NEG / SQR dst, a
//   HORNER acc, v, k        slot[acc] = slot[acc] * consts[k] + slot[v]
//   OUT    -, a             out[row] = slot[a]
// It is thousands of instructions long (the RSA-SHA256 part: about 7,000),
// beyond the 64 KB of constant memory, so it is read from device memory:
// every thread of a warp reads the same word (a broadcast that stays in
// L1), so the branch on the opcode is uniform and nothing diverges.  The
// next instruction is loaded while the current one runs.  Leaves are
// (pointer, row stride) pairs, so strided column views need no copy.  The
// slots live in shared memory laid out [slot][limb][thread]: a warp's 32
// threads touch 32 consecutive words, with no bank conflict.  Each thread
// owns its column of every slot, so no barrier is needed.
//
// Bound on the H100: the operations, 32-bit integer multiplies (a program
// of the RSA part takes about 580 Montgomery products a row), unless the
// program reads many leaves and multiplies little; the bytes are each leaf
// read once and the output written once.  With one thread a row, n =
// 32,768 rows are 256 blocks of 128 threads, about 2 a SM: 8 warps, 2 a
// scheduler, too few to hide the carry chains' latency, so the kernel runs
// well above its operations bound.  Splitting a row's program across
// threads is the next step if the kernel comes to matter.
#include "field.cuh"

namespace {

constexpr int kThreads = 128;

enum Op : int {
  kLoad = 0, kConst = 1, kAdd = 2, kSub = 3, kNeg = 4, kMul = 5, kSqr = 6,
  kHorner = 7, kOut = 8
};

struct Leaf {
  long long ptr;     // device address of row 0
  long long stride;  // 32-bit words from one row to the next
};

__device__ __forceinline__ Fe slot_get(const uint32_t* slots, int s) {
  const uint32_t* p = slots + s * (H2_LIMBS * kThreads) + threadIdx.x;
  Fe r;
#pragma unroll
  for (int l = 0; l < H2_LIMBS; l++) r.v[l] = p[l * kThreads];
  return r;
}

__device__ __forceinline__ void slot_put(uint32_t* slots, int s,
                                         const Fe& a) {
  uint32_t* p = slots + s * (H2_LIMBS * kThreads) + threadIdx.x;
#pragma unroll
  for (int l = 0; l < H2_LIMBS; l++) p[l * kThreads] = a.v[l];
}

__global__ void __launch_bounds__(kThreads)
field_prog_kernel(const int4* __restrict__ prog, int n_instr,
                  const Leaf* __restrict__ leaves,
                  const uint32_t* __restrict__ consts,
                  uint32_t* __restrict__ out, long long n,
                  const __grid_constant__ Modulus M) {
  extern __shared__ uint32_t slots[];
  const long long row = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (row >= n) return;
  int4 ins = __ldg(prog);
  for (int pc = 0; pc < n_instr; pc++) {
    const int4 next = __ldg(prog + (pc + 1 < n_instr ? pc + 1 : pc));
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
        slot_put(slots, ins.y, fe_sub(fe_zero(), slot_get(slots, ins.z), M));
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
        fe_store(out + row * H2_LIMBS, slot_get(slots, ins.z));
        break;
    }
    ins = next;
  }
}

}  // namespace

// prog: n_instr int4 instructions; leaves: (pointer, row stride) pairs of
// int64; consts: (K, 8) words; out: (n, 8) words; slots: the program's
// slot count (shared memory: slots * 4 KB a block).  Every pointer 16-byte
// aligned, every leaf stride a multiple of 4 words.  Returns
// cudaGetLastError().
extern "C" int h2_field_prog(const void* prog, int n_instr,
                             const void* leaves, const void* consts,
                             void* out, long long n, int slots,
                             const uint32_t* mod, void* stream) {
  const Modulus M = modulus_from_words(mod);
  const size_t smem = (size_t)slots * H2_LIMBS * kThreads * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        field_prog_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (n > 0 && n_instr > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    field_prog_kernel<<<(unsigned)blocks, kThreads, smem,
                        (cudaStream_t)stream>>>(
        (const int4*)prog, n_instr, (const Leaf*)leaves,
        (const uint32_t*)consts, (uint32_t*)out, n, M);
  }
  return (int)cudaGetLastError();
}
