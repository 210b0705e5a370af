// 3xTF32 tensor-core GEMM building blocks for Hopper (sm_90a), shared by
// csrc/fused_logprob_fwd.cu and csrc/fused_logprob_bwd.cu. The type-agnostic
// pieces (tensor maps, mbarriers, TMA, wgmma fences, descriptors) are in
// csrc/hopper.cuh.
//
// Numerics. Each f32 operand x is split into two TF32 numbers,
//   hi = rna_tf32(x)   and   lo = rna_tf32(x - hi)
// (x - hi is exact in f32; hi + (x - hi) == x). The products run on wgmma
// with tf32 operands and f32 accumulators as hi*hi + hi*lo + lo*hi into one
// accumulator; the dropped lo*lo term and the rounding of lo are about 2^-21
// of |x y|, so the result agrees with an f32 product to f32 summation order
// (tests/test_torch_tf32x3.py emulates this split bit for bit on the CPU).
// Both parts are stored already rounded, so the tensor cores read them
// exactly (they would otherwise drop the low 13 bits of an f32 word).
//
// The tensor cores' own f32 accumulation truncates as it adds, so its error
// grows with K and with the running sum: accumulating all of K = 4096 in
// the wgmma accumulator put the logprobs several times the port's 1e-4
// tolerance from an f32 product on the H100. So each 32-deep stage starts a
// fresh wgmma accumulator, and the consumer adds it into the tile's sum with
// f32 adds (round to nearest).
//
// Layout. For 32-bit types wgmma takes only K-major operands (no transpose
// for tf32), so A is [M, K] and B is [N, K], K contiguous. tf32x3_split
// (csrc/fused_logprob_fwd.cu) makes the hi/lo operands once per call (the
// head [D, V] becomes [V, D] for the logits, and stays [D, V] for dH =
// coef head^T; hidden [N, D] becomes [D, N] for dW = hidden^T coef).
//
// Pipeline. One block = two consumer warpgroups (rows 0-63 and 64-127 of a
// 128-row tile) + one producer warp. The producer's lane 0 issues TMA loads
// (cp.async.bulk.tensor, 128-byte swizzle: 32 f32 make one K row) of the four
// tiles of a stage (A hi, A lo, B hi, B lo) into a ring of STAGES stages,
// each with a "full" mbarrier (TMA transaction bytes) and an "empty" one
// (all 256 consumer threads arrive after the wgmma that read it completed).
// Each consumer warpgroup issues 12 wgmma m64n128k8 per 32-deep stage,
// waits for them, frees the stage and adds the stage's products into its
// sum. (Keeping one stage's products in flight while adding the last one's
// needs a second fragment: at 288 threads a thread has 168 registers and
// that spilled; at 384 threads with setmaxnreg it ran no faster on the H100.)
// TMA fills out-of-bounds elements with zeros, so ragged M, N and K edges
// add nothing to the products; the epilogues mask what they write.

#pragma once

#include "hopper.cuh"

namespace tc {

using namespace hopper;

constexpr int BM = 128;           // rows per block: two consumer warpgroups of 64
constexpr int BN = 128;           // columns per block: one m64n128k8 per warpgroup
constexpr int BK = 32;            // K per stage: one 128-byte swizzled row of f32
constexpr int NACC = BN / 2;      // f32 accumulators per consumer thread
constexpr int NCONSUMER = 256;    // two warpgroups
constexpr int NTHREADS = 288;     // + one producer warp
constexpr int A_BYTES = BM * BK * 4;  // 16 KB
constexpr int B_BYTES = BN * BK * 4;  // 16 KB
constexpr int STAGE_BYTES = 2 * (A_BYTES + B_BYTES);  // hi and lo of A and B: 64 KB
constexpr int STAGES = 3;         // 192 KB of the 227 KB a block can have
constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;  // + alignment, barriers

// ------------------------------- host side --------------------------------- //

// A 2-D f32 matrix [outer, inner] with row stride ld (elements), read in
// boxes of [box_outer, 32] with the 128-byte swizzle. Returns a cudaError_t.
static inline int make_map(CUtensorMap* m, const float* p, long long inner, long long outer,
                           long long ld, int box_outer) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if ((ld * 4) % 16 != 0 || reinterpret_cast<uintptr_t>(p) % 16 != 0 || inner <= 0 || outer <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  cuuint64_t strides[1] = {(cuuint64_t)(ld * 4)};
  cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_outer};
  cuuint32_t es[2] = {1, 1};
  CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p), dims, strides, box,
                  es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------ device side -------------------------------- //

__device__ __forceinline__ float rna_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// d = A B^T + (scale_d ? d : 0) for one k8 slice, m64n128k8, tf32 operands
// from shared memory (descriptors), f32 accumulators in registers
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[NACC], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Ring position, the same sequence on the producer and the consumers.
struct Pipe {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// Shared memory: STAGES x {A hi, A lo, B hi, B lo}, then full[STAGES], empty[STAGES].
struct Ring {
  uint32_t base;
  __device__ __forceinline__ uint32_t stage(int s) const { return base + s * STAGE_BYTES; }
  __device__ __forceinline__ uint32_t full(int s) const { return stage(STAGES) + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return full(STAGES + s); }
};

// Aligns the ring, initialises its barriers and syncs the block. Every
// thread of the block calls it once, before the roles split.
__device__ __forceinline__ Ring ring_setup(uint8_t* smem) {
  Ring r{(smem_u32(smem) + 1023u) & ~1023u};
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(r.full(s), 1);
      mbar_init(r.empty(s), NCONSUMER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return r;
}

struct Maps {
  const CUtensorMap* a_hi;
  const CUtensorMap* a_lo;
  const CUtensorMap* b_hi;
  const CUtensorMap* b_lo;
};

// Producer (one thread): the nk stages of one output tile. A rows m0.., K
// from a_k0; B rows n0.., K from b_k0.
__device__ __forceinline__ void load_tile(const Maps& mp, const Ring& r, Pipe& p, int m0, int n0,
                                          int a_k0, int b_k0, int nk) {
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(r.empty(p.stage), p.phase ^ 1u);
    const uint32_t full = r.full(p.stage);
    const uint32_t s = r.stage(p.stage);
    mbar_expect_tx(full, STAGE_BYTES);
    tma_load(s, mp.a_hi, full, a_k0 + kt * BK, m0);
    tma_load(s + A_BYTES, mp.a_lo, full, a_k0 + kt * BK, m0);
    tma_load(s + 2 * A_BYTES, mp.b_hi, full, b_k0 + kt * BK, n0);
    tma_load(s + 2 * A_BYTES + B_BYTES, mp.b_lo, full, b_k0 + kt * BK, n0);
    p.advance();
  }
}

// Consumer warpgroup wg: acc = (A rows wg*64.. of the tile) B^T over nk
// stages, in 3xTF32. Accumulator acc[j] of thread t (warp w = t / 32 % 4,
// lane l) is row w*16 + l/4 + 8*((j/2)%2), column (j/4)*8 + (l%4)*2 + j%2.
__device__ __forceinline__ void mma_tile(float (&acc)[NACC], const Ring& r, Pipe& p, int nk,
                                         int wg) {
  float part[NACC];  // one stage's products, from the tensor cores
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(r.full(p.stage), p.phase);
    const uint32_t s = r.stage(p.stage);
    const uint64_t ah = desc_sw128(s + wg * 64 * 128);
    const uint64_t al = desc_sw128(s + A_BYTES + wg * 64 * 128);
    const uint64_t bh = desc_sw128(s + 2 * A_BYTES);
    const uint64_t bl = desc_sw128(s + 2 * A_BYTES + B_BYTES);
    fence_acc(part);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 8; ++k) {  // a k8 step is 32 bytes: +2 in the descriptor
      wgmma_m64n128k8(part, ah + 2 * k, bh + 2 * k, k > 0);
      wgmma_m64n128k8(part, ah + 2 * k, bl + 2 * k, 1);
      wgmma_m64n128k8(part, al + 2 * k, bh + 2 * k, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(part);
    mbar_arrive(r.empty(p.stage));
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] += part[i];
    p.advance();
  }
}

}  // namespace tc
