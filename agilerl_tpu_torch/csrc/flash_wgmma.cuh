// bf16 flash-attention building blocks for Hopper (sm_90a), shared by the
// wgmma kernels of csrc/flash_attention_fwd.cu (out, lse) and
// csrc/flash_attention_bwd.cu (dQ, dK/dV).
//
// - tiles: 64 rows x d bf16 (d = 64, 128 or 256), held in shared memory as
//   d / 64 TMA boxes of [64 rows][64 bf16] with the 128-byte swizzle
//   (hopper.cuh's 4-D maps);
// - a block's shared memory: NRES resident tiles, a ring of STAGES stages of
//   two streamed tiles (a, b), full/empty mbarriers for the pair (or, SPLIT,
//   for each tile of it), and the resident tiles' barrier, then the first
//   visible key of each kv tile;
// - the in-kernel skip rule's table (one warp ballot per 64 keys of the
//   mask; tests/test_torch_flash_plan.py holds its plain version);
// - bf16 wgmma with both operands in shared memory (K-major), and with A
//   from registers (the accumulator of an earlier product, packed to bf16)
//   and B MN-major through the transpose bit;
// - for head dims past 256, the wide kernels' ring of 32 KB units (Ring,
//   WPipe, feed): any sequence of box loads that both sides walk alike.

#pragma once

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace flash {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;               // query rows per tile
constexpr int BK = 64;               // keys per tile
constexpr int NCONS = 128;           // one consumer warpgroup
constexpr int WG_NT = NCONS + 32;    // one consumer warpgroup + one producer warp
constexpr int BOX = 64 * 128;        // one [64 rows][64 bf16] swizzled box: 8 KB
constexpr int STAGES = 2;

template <int HD>
__host__ __device__ constexpr int tile_bytes() {  // a [64, HD] tile: HD / 64 boxes
  return HD / 64 * BOX;
}

// alignment slack; NRES resident tiles; STAGES x two streamed tiles; full,
// empty (and, SPLIT, full_b, empty_b) [STAGES] and the resident tiles'
// barrier; the first visible key of each of the nt kv tiles
template <int HD, int NRES, bool SPLIT = false>
constexpr int wgmma_smem_bytes(int nt) {
  return 1024 + (NRES + 2 * STAGES) * tile_bytes<HD>() + ((SPLIT ? 4 : 2) * STAGES + 1) * 8 + 4 * nt;
}

__device__ __forceinline__ int key_visible(const int* mask, int T, int b, int key) {
  return key < T && (mask == nullptr || mask[(long long)b * T + key] > 0);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d = A B^T + (scale_d ? d : 0), m64n32k16: A and B K-major bf16 in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d = A B^T + (scale_d ? d : 0), m64n64k16: A and B K-major bf16 in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d = A B + (scale_d ? d : 0), m64n64k16: A bf16 from registers (the
// accumulator layout, packed in pairs), B MN-major bf16 in shared memory
// (transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d = A B + (scale_d ? d : 0), m64n128k16: A bf16 from registers (the
// accumulator layout, packed in pairs), B MN-major bf16 in shared memory
// (transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d += A B for a [64, N] accumulator, B MN-major at shared address b: one
// product up to N = 128, else N / 128 products of n = 128 (a thread's
// accumulator entries 64 c .. 64 c + 63 are columns 128 c .. 128 c + 127,
// whose B starts two boxes on)
template <int N>
__device__ __forceinline__ void wgmma_rs_wide(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint32_t b, int scale_d) {
  if constexpr (N <= 128) {
    wgmma_rs(d, a, desc_sw128_mn(b, BOX), scale_d);
  } else {
#pragma unroll
    for (int c = 0; c < N / 128; ++c)
      wgmma_rs(*reinterpret_cast<float(*)[64]>(&d[64 * c]), a,
               desc_sw128_mn(b + c * 2 * BOX, BOX), scale_d);
  }
}

// Shared memory of a block: resident tiles res(0 .. NRES - 1); stage s holds
// the streamed tiles a (at stage(s)) and b (at stage(s) + tile); then the
// barriers, then the first visible key of each kv tile. full / empty cover
// the pair of a stage; SPLIT, they cover tile a alone and full_b / empty_b
// tile b (so that each can be freed as soon as its own product is done).
template <int HD, int NRES, bool SPLIT = false>
struct Smem {
  uint32_t base;
  int* first;
  __device__ __forceinline__ uint32_t res(int i) const { return base + i * tile_bytes<HD>(); }
  __device__ __forceinline__ uint32_t stage(int s) const {
    return base + (NRES + 2 * s) * tile_bytes<HD>();
  }
  __device__ __forceinline__ uint32_t full(int s) const { return stage(STAGES) + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return full(STAGES + s); }
  __device__ __forceinline__ uint32_t full_b(int s) const { return full(2 * STAGES + s); }
  __device__ __forceinline__ uint32_t empty_b(int s) const { return full(3 * STAGES + s); }
  __device__ __forceinline__ uint32_t res_bar() const { return full((SPLIT ? 4 : 2) * STAGES); }
};

// The first visible key of the 64-key tile at k0 (>= T when it has none),
// found by one warp: two ballots over the tile's keys.
__device__ __forceinline__ int first_visible_key(const int* mask, int T, int b, int k0) {
  const int lane = threadIdx.x & 31;
  const unsigned lo = __ballot_sync(0xffffffffu, key_visible(mask, T, b, k0 + lane));
  const unsigned hi = __ballot_sync(0xffffffffu, key_visible(mask, T, b, k0 + 32 + lane));
  return lo ? k0 + __ffs(lo) - 1 : hi ? k0 + 31 + __ffs(hi) : T;
}

// Aligns the shared memory, initialises the barriers, fills first[kt] for
// the kv tiles kt0 .. kt1 - 1 (one warp a tile) and syncs the block.
template <int HD, int NRES, bool SPLIT = false>
__device__ __forceinline__ Smem<HD, NRES, SPLIT> smem_setup(unsigned char* raw, const int* mask,
                                                            int T, int b, int kt0, int kt1) {
  const uint32_t base = (smem_u32(raw) + 1023u) & ~1023u;
  Smem<HD, NRES, SPLIT> sm{base, nullptr};
  sm.first = reinterpret_cast<int*>(raw + (sm.res_bar() + 8 - smem_u32(raw)));
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), NCONS);
      if (SPLIT) {
        mbar_init(sm.full_b(s), 1);
        mbar_init(sm.empty_b(s), NCONS);
      }
    }
    mbar_init(sm.res_bar(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int kt = kt0 + (int)(threadIdx.x >> 5); kt < kt1; kt += WG_NT / 32)
    sm.first[kt] = first_visible_key(mask, T, b, kt * BK);
  __syncthreads();
  return sm;
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

// Wide head dims (d > 256, any multiple of 64): a block owns a column group
// of its output and recomputes the scores over the whole of d, streamed in
// 64-column chunks. Its shared memory is a ring of WSTAGES units of WUNIT
// boxes (Q and K chunks, or the group's columns of an output operand), a
// full and an empty mbarrier a unit, then the first visible key of each kv
// tile. The producer and the consumers walk the same sequence of units.
constexpr int WSTAGES = 4;
constexpr int WUNIT = 4;  // boxes a unit: 32 KB

constexpr int wide_smem_bytes(int nt) {
  return 1024 + WSTAGES * WUNIT * BOX + 2 * WSTAGES * 8 + 4 * nt;
}

struct Ring {
  uint32_t base;
  int* first;
  __device__ __forceinline__ uint32_t unit(int s) const { return base + s * WUNIT * BOX; }
  __device__ __forceinline__ uint32_t full(int s) const {
    return base + WSTAGES * WUNIT * BOX + 8 * s;
  }
  __device__ __forceinline__ uint32_t empty(int s) const { return full(WSTAGES + s); }
};

// Ring position over WSTAGES units, the same sequence on both sides.
struct WPipe {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == WSTAGES) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// Aligns the shared memory, initialises the ring's barriers, fills first[kt]
// for the kv tiles kt0 .. kt1 - 1 (one warp a tile) and syncs the block.
__device__ __forceinline__ Ring ring_setup(unsigned char* raw, const int* mask, int T, int b,
                                           int kt0, int kt1) {
  const uint32_t base = (smem_u32(raw) + 1023u) & ~1023u;
  Ring r{base, nullptr};
  r.first = reinterpret_cast<int*>(raw + (r.full(2 * WSTAGES) - smem_u32(raw)));
  if (threadIdx.x == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(r.full(s), 1);
      mbar_init(r.empty(s), NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int kt = kt0 + (int)(threadIdx.x >> 5); kt < kt1; kt += WG_NT / 32)
    r.first[kt] = first_visible_key(mask, T, b, kt * BK);
  __syncthreads();
  return r;
}

// Producer: the next unit of the ring, filled with n boxes; loads[i] = (map,
// column, row, head) of box i. Waits until the consumers freed the unit.
struct BoxLoad {
  const CUtensorMap* map;
  int col, row, h;
};

template <int N>
__device__ __forceinline__ void feed(const Ring& ring, WPipe& pipe, const BoxLoad (&loads)[N],
                                     int n, int b) {
  const uint32_t u = ring.unit(pipe.stage), full = ring.full(pipe.stage);
  mbar_wait(ring.empty(pipe.stage), pipe.phase ^ 1u);
  mbar_expect_tx(full, n * BOX);
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) tma_load_4d(u + i * BOX, loads[i].map, full, loads[i].col, loads[i].row, loads[i].h, b);
  pipe.advance();
}

// Producer: the 64-row tile at row r0 of head h, batch b, as HD / 64 boxes
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int r0, int h, int b) {
#pragma unroll
  for (int c = 0; c < HD / 64; ++c) tma_load_4d(dst + c * BOX, map, bar, c * 64, r0, h, b);
}

// Consumer: the byte offset in a [64, HD] tile of the k16 step kk along HD
// (K-major operands: 32 bytes a step, the next box every four steps)
__device__ __forceinline__ uint32_t kmajor_step(int kk) { return (kk >> 2) * BOX + (kk & 3) * 32; }

// Keeps the compiler from reusing the registers of a register A operand
// before the wgmma that reads them is known to be done (call after the wait).
__device__ __forceinline__ void fence_a(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// The accumulator's pairs (j, j + 1) of keys / queries 16 kk .. 16 kk + 15 as
// the A operand of an m64nNk16 product: accumulator j of a thread is row
// (warp * 16 + lane / 4 + 8 * ((j / 2) % 2)), column (j / 4) * 8 + (lane % 4)
// * 2 + j % 2; the A fragment wants rows r, r + 8 at columns c, c + 8.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&x)[N], int kk) {
  a[0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
  a[1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
  a[2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
  a[3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
}

}  // namespace flash
