// Type-agnostic Hopper (sm_90a) building blocks shared by the port's TMA +
// wgmma kernels: csrc/tf32x3_gemm.cuh (the fused lm-head forward, dH and dW)
// and csrc/flash_wgmma.cuh (the bf16 flash forward and backward).
//
// - host: cuTensorMapEncodeTiled through the runtime (nothing links against
//   libcuda), and a 4-D bf16 tensor map for strided [B, H, T, d] views;
// - device: shared-memory addresses, mbarriers, TMA loads (2-D and 4-D), the
//   wgmma fence / commit / wait, an accumulator fence for the compiler, and
//   the wgmma shared-memory descriptors of 128-byte swizzled tiles.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ------------------------------- host side --------------------------------- //

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function; take it through the runtime
// so that the library links against nothing but cudart.
static inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// A strided bf16 view [B, H, T, d] (element strides sb, sh, st over b, h, t;
// d contiguous) as a 4-D map (d, T, H, B), read in boxes of [rows, 64]: 64
// bf16 make one 128-byte swizzled row, so a d = 128 row is two boxes. Rows
// at or past T read as zeros. Returns a cudaError_t.
static inline int make_map_bf16_4d(CUtensorMap* m, const void* p, int B, int H, int T, int d,
                                   long long sb, long long sh, long long st, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0 || (sb * 2) % 16 != 0 || (sh * 2) % 16 != 0 ||
      (st * 2) % 16 != 0 || B <= 0 || H <= 0 || T <= 0 || d % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // a stride of a dimension of size 1 is never used: give it a legal value
  const long long row = (long long)d * 2;
  cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)T, (cuuint64_t)H, (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)(T > 1 ? st * 2 : row), (cuuint64_t)(H > 1 ? sh * 2 : row),
                           (cuuint64_t)(B > 1 ? sb * 2 : row)};
  for (int i = 0; i < 3; ++i)
    if (strides[i] == 0) return static_cast<int>(cudaErrorInvalidValue);
  cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  cuuint32_t es[4] = {1, 1, 1, 1};
  CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides, box,
                  es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------ device side -------------------------------- //

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Spins on an mbarrier phase. A wait that has not completed after 10 s (the
// %globaltimer is read once every 1024 failed polls) is a pipeline fault, a
// phase that never completes: the kernel traps rather than hanging the card.
// A trap leaves the process's CUDA context unusable, so the process is lost,
// not just the launch. The limit is far above a time slice of a card shared
// with other contexts, which the timer also counts.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t n = 1;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((n & 1023u) == 0) {
      uint64_t t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      if (t0 == 0) t0 = t;
      else if (t - t0 > 10000000000ull) __trap();
    }
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// box at coordinates (k, row) of a 2-D map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row)
      : "memory");
}

// box at coordinates (c0, c1, c2, c3), innermost first, of a 4-D map
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across a wgmma
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptors, 128-byte swizzle (layout type 1 in bits
// 62-63), start address >> 4 in bits 0-13, leading byte offset >> 4 in bits
// 16-29, stride byte offset >> 4 in bits 32-45; tiles 1024-byte aligned.
//
// K-major operand: rows of 128 bytes (K contiguous), 8-row groups 1024 bytes
// apart (SBO); the LBO is unused. A step of 32 bytes along K (k8 of tf32,
// k16 of bf16) adds 2 to the start-address field.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// MN-major operand (MN contiguous, read through wgmma's transpose bit; 16-bit
// types only): each K row holds 64 MN values in 128 swizzled bytes, 8-row
// groups along K are SBO = 1024 bytes apart, and the next 64 MN values (the
// next swizzle atom) are LBO bytes on. A k16 step is 16 rows: 2048 bytes.
__device__ __forceinline__ uint64_t desc_sw128_mn(uint32_t addr, uint32_t lbo_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (64ull << 32) | (1ull << 62);
}

}  // namespace hopper
