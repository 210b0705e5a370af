// Flash attention backward (dQ and dK/dV) for Hopper, sm_90a.
//
// Replaces the TPU kernels agilerl_tpu/ops/flash_attention_vjp.py:_dq_kernel
// (pallas_call in _bwd_arrays, the dq call) and :_dkv_kernel (the dk/dv call).
//
// What they compute, per (batch b, query head h), from the forward's lse and
// D = rowsum(dO * O) (minus the lse cotangent, if any), computed by the
// caller before the launch as the JAX package does outside its kernels:
//   s_ij  = (q_i . k_j) * scale,   visible unless j >= T, (causal) j > i, or
//           padding_mask[b, j] == 0
//   p_ij  = visible ? exp(s_ij - lse_i) : 0
//   ds_ij = p_ij * (dO_i . v_j - D_i)
//   dQ_i  = scale * sum_j round(ds_ij) k_j
//   dV_j  = sum_i round(p_ij) dO_i          dK_j = scale * sum_i round(ds_ij) q_i
// where round() is the TPU kernels' cast to the input type before a product
// (ds.astype(k.dtype), p.astype(do.dtype)): bf16 inputs round p and ds to
// bf16, f32 inputs leave them. Products accumulate in f32.
//
// Translation. The TPU grids carry an f32 accumulator in VMEM along a
// sequential axis (kv innermost for dQ, q innermost for dK/dV). Here one
// thread block owns one output tile and walks the other axis in a loop with
// the accumulator in registers:
// - dQ: one block per (b * H, 64-row q tile), looping over kv tiles up to the
//   causal bound;
// - dK/dV: one block per (b * Hkv, 64-key kv tile), looping over the H / Hkv
//   query heads of its GQA group and, for each, the q tiles from the causal
//   start on. The JAX model repeats K/V before its kernel and jnp.repeat's
//   transpose sums the group; the port passes K/V unrepeated, so the block
//   sums the group itself: deterministic, no atomics.
//
// Two kernels of each, chosen by the input type (as the forward):
// - bf16 (the model's path): tensor cores. Each of 4 warps owns 16 rows of
//   the block's tile (query rows for dQ, key rows for dK/dV) and runs
//   mma.sync m16n8k16 (bf16 in, f32 accumulate) for both score-sized
//   products (S = Q K^T and dP = dO V^T, or their transposes), then for the
//   output products. The score accumulator fragments are laid out as the A
//   operand of the output product, so p and ds go from registers to it,
//   rounded to bf16 on the way. Operands read along the head dimension are
//   staged row-major ([64][d + 8]); operands read along the sequence are
//   staged transposed ([d][64 + 8]), so every B register is one conflict-free
//   32-bit read. dK/dV walks its 64 query columns in two halves of 32 to
//   keep its two [16, d] accumulators in registers.
// - f32: the products as f32 FMAs (no tensor cores: TF32 would lose the f32
//   inputs' precision), 256 threads in a 16 x 16 grid over tiles staged
//   transposed in shared memory ([d][64 + 1] floats).
//
// What bounds it on the H100. At the GRPO learn shapes ([16, 32/8, 320, 128]
// bf16) the bytes (q, k, v, dO, lse, D read once; dQ or dK/dV written once)
// take 0.04 ms, the work (6 or 8 flops per visible (q, k) pair and head
// dimension) 0.01-0.02 ms on bf16 tensor cores: memory-bound by the card's
// measure. The bf16 kernels' own limits are the per-block setup at small T
// (a tile meets at most T / 64 others), re-staging the same Q/dO/K/V tiles
// from L2 for every tile pair, and mma.sync instead of wgmma; TMA and wgmma
// are the next step. PERF.md holds their times beside the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // keys per tile

struct Params {
  const void* q;     // [B, H, T, d], strided over (b, h, t)
  const void* k;     // [B, Hkv, T, d], strided
  const void* v;     // [B, Hkv, T, d], strided
  const void* dout;  // [B, H, T, d], strided
  const float* lse;  // [B, H, T] contiguous
  const float* dd;   // [B, H, T] contiguous
  const int* mask;   // [B, T] or null
  void* dq;          // [B, H, T, d] contiguous
  void* dk;          // [B, Hkv, T, d] contiguous
  void* dv;          // [B, Hkv, T, d] contiguous
  int B, H, Hkv, T;
  long long sqb, sqh, sqt, skb, skh, skt, svb, svh, svt, sob, soh, sot;
  int causal;
  float scale;
};

__device__ __forceinline__ int key_visible(const Params& p, int b, int key) {
  return key < p.T && (p.mask == nullptr || p.mask[(long long)b * p.T + key] > 0);
}

// ------------------------------ bf16: tensor cores ------------------------- //

typedef __nv_bfloat16 bf16;
constexpr int MMA_NT = 128;  // 4 warps x 16 rows
constexpr int QH = 32;       // query columns per half in dK/dV

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes (8 bf16) from global memory; the wrapper checks the alignment
__device__ __forceinline__ uint4 ld128(const bf16* p) { return *reinterpret_cast<const uint4*>(p); }

// rows [r0, r0 + 64) of a [T, HD] slice (row stride st) into dst[64][HD + 8];
// rows at or past T read as 0
template <int HD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long long st, int r0,
                                           int seq) {
  constexpr int C8 = HD / 8, LDR = HD + 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int e = threadIdx.x; e < 64 * C8; e += MMA_NT) {
    const int r = e / C8, c = (e % C8) * 8;
    const int row = r0 + r;
    *reinterpret_cast<uint4*>(&dst[r * LDR + c]) = row < seq ? ld128(src + row * st + c) : zero;
  }
}

// the same rows transposed into dst[HD][64 + 8]; consecutive threads take
// consecutive rows, so the 16-bit stores into a row of dst are conflict-free
template <int HD>
__device__ __forceinline__ void stage_cols(bf16* dst, const bf16* src, long long st, int r0,
                                           int seq) {
  constexpr int LDT = 64 + 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int e = threadIdx.x; e < 64 * (HD / 8); e += MMA_NT) {
    const int r = e % 64, c = (e / 64) * 8;
    const int row = r0 + r;
    const uint4 raw = row < seq ? ld128(src + row * st + c) : zero;
    const bf16* x = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(c + i) * LDT + r] = x[i];
  }
}

template <int HD>
constexpr int dq_mma_smem_bytes() {
  // Qs, dOs, Ks, Vs [64][HD + 8]; Kt [HD][64 + 8] bf16; lse, D, visibility [64]
  return (4 * 64 * (HD + 8) + HD * (64 + 8)) * 2 + 3 * 64 * 4;
}

template <int HD>
constexpr int dkv_mma_smem_bytes() {
  // Ks, Vs, Qs, dOs [64][HD + 8]; Qt, dOt [HD][64 + 8] bf16; lse, D, visibility [64]
  return (4 * 64 * (HD + 8) + 2 * HD * (64 + 8)) * 2 + 3 * 64 * 4;
}

template <int HD>
__global__ void __launch_bounds__(MMA_NT) flash_dq_mma_kernel(const Params p) {
  constexpr int LDR = HD + 8;  // row pitch of row-major tiles: conflict-free 32-bit reads
  constexpr int LDT = BK + 8;  // row pitch of the transposed K tile
  constexpr int NS = BK / 8;   // score n-tiles (8 keys each)
  constexpr int NO = HD / 8;   // output n-tiles (8 dims each)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Os = Qs + BQ * LDR;
  bf16* Ks = Os + BQ * LDR;
  bf16* Vs = Ks + BK * LDR;
  bf16* Kt = Vs + BK * LDR;
  float* row_lse = reinterpret_cast<float*>(Kt + HD * LDT);
  float* row_dd = row_lse + BQ;
  int* pm = reinterpret_cast<int*>(row_dd + BQ);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;  // fragment row group
  const int tg = tid & 3;         // thread in group
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = blockIdx.x * BQ;
  const int seq = p.T;

  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.skb + hk * p.skh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.svb + hk * p.svh;
  stage_rows<HD>(Qs, static_cast<const bf16*>(p.q) + b * p.sqb + h * p.sqh, p.sqt, q0, seq);
  stage_rows<HD>(Os, static_cast<const bf16*>(p.dout) + b * p.sob + h * p.soh, p.sot, q0, seq);
  if (tid < BQ) {
    const int row = q0 + tid;
    const long long at = (long long)bh * seq + row;
    row_lse[tid] = row < seq ? p.lse[at] : 0.f;
    row_dd[tid] = row < seq ? p.dd[at] : 0.f;
  }

  const int r0 = warp * 16 + g;  // this thread's two query rows in the tile
  const int qrow0 = q0 + r0;
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int kv_end = p.causal ? min(seq, q0 + BQ) : seq;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done (and Qs, dOs stored)
    stage_rows<HD>(Ks, kg, p.skt, k0, seq);
    stage_rows<HD>(Vs, vg, p.svt, k0, seq);
    stage_cols<HD>(Kt, kg, p.skt, k0, seq);
    if (tid < BK) pm[tid] = key_visible(p, b, k0 + tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int c = kk * 16 + tg * 2;
      const uint32_t qa0 = ld32(&Qs[r0 * LDR + c]), qa1 = ld32(&Qs[(r0 + 8) * LDR + c]);
      const uint32_t qa2 = ld32(&Qs[r0 * LDR + c + 8]), qa3 = ld32(&Qs[(r0 + 8) * LDR + c + 8]);
      const uint32_t oa0 = ld32(&Os[r0 * LDR + c]), oa1 = ld32(&Os[(r0 + 8) * LDR + c]);
      const uint32_t oa2 = ld32(&Os[r0 * LDR + c + 8]), oa3 = ld32(&Os[(r0 + 8) * LDR + c + 8]);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const bf16* kr = &Ks[(n * 8 + g) * LDR + c];
        mma_bf16(s[n], qa0, qa1, qa2, qa3, ld32(kr), ld32(kr + 8));
        const bf16* vr = &Vs[(n * 8 + g) * LDR + c];
        mma_bf16(dp[n], oa0, oa1, oa2, oa3, ld32(vr), ld32(vr + 8));
      }
    }

    // ds = p (dP - D); s[n][0..1] belong to row r0, s[n][2..3] to row r0 + 8
    const float lse_r[2] = {row_lse[r0], row_lse[r0 + 8]};
    const float dd_r[2] = {row_dd[r0], row_dd[r0 + 8]};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + tg * 2 + (e & 1);
        const int qrow = qrow0 + (e >> 1) * 8;
        const bool ok = pm[col] && (!p.causal || k0 + col <= qrow);
        const float pr = ok ? expf(s[n][e] * p.scale - lse_r[e >> 1]) : 0.f;
        s[n][e] = pr * (dp[n][e] - dd_r[e >> 1]);
      }
    }

    // dQ += round(dS) K: the dS fragments of keys 16kk..16kk+15 are the A operand
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const bf16* kr = &Kt[(j * 8 + g) * LDT + kk * 16 + tg * 2];
        mma_bf16(acc[j], a0, a1, a2, a3, ld32(kr), ld32(kr + 8));
      }
    }
  }

  bf16* dq = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow0 + r * 8;
    if (row < seq) {
      const long long base = ((long long)bh * seq + row) * HD;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        *reinterpret_cast<uint32_t*>(&dq[base + j * 8 + tg * 2]) =
            pack_bf16(acc[j][2 * r] * p.scale, acc[j][2 * r + 1] * p.scale);
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(MMA_NT) flash_dkv_mma_kernel(const Params p) {
  constexpr int LDR = HD + 8;
  constexpr int LDT = BQ + 8;
  constexpr int NQ = QH / 8;  // score n-tiles per half (8 queries each)
  constexpr int NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BK * LDR;
  bf16* Qs = Vs + BK * LDR;
  bf16* Os = Qs + BQ * LDR;
  bf16* Qt = Os + BQ * LDR;
  bf16* Ot = Qt + HD * LDT;
  float* row_lse = reinterpret_cast<float*>(Ot + HD * LDT);
  float* row_dd = row_lse + BQ;
  int* pm = reinterpret_cast<int*>(row_dd + BQ);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int tg = tid & 3;
  const int bk = blockIdx.y;
  const int b = bk / p.Hkv;
  const int hk = bk - b * p.Hkv;
  const int rep = p.H / p.Hkv;
  const int k0 = blockIdx.x * BK;
  const int seq = p.T;

  stage_rows<HD>(Ks, static_cast<const bf16*>(p.k) + b * p.skb + hk * p.skh, p.skt, k0, seq);
  stage_rows<HD>(Vs, static_cast<const bf16*>(p.v) + b * p.svb + hk * p.svh, p.svt, k0, seq);
  if (tid < BK) pm[tid] = key_visible(p, b, k0 + tid);

  const int r0 = warp * 16 + g;  // this thread's two key rows in the tile
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  // q tiles wholly before this kv tile see none of its keys (causal)
  const int q_start = p.causal ? (k0 / BQ) * BQ : 0;
  for (int h = hk * rep; h < (hk + 1) * rep; ++h) {
    const int bh = b * p.H + h;
    const bf16* qg = static_cast<const bf16*>(p.q) + b * p.sqb + h * p.sqh;
    const bf16* og = static_cast<const bf16*>(p.dout) + b * p.sob + h * p.soh;
    for (int q0 = q_start; q0 < seq; q0 += BQ) {
      __syncthreads();  // the previous tile's readers are done (and Ks, Vs stored)
      stage_rows<HD>(Qs, qg, p.sqt, q0, seq);
      stage_rows<HD>(Os, og, p.sot, q0, seq);
      stage_cols<HD>(Qt, qg, p.sqt, q0, seq);
      stage_cols<HD>(Ot, og, p.sot, q0, seq);
      if (tid < BQ) {
        const int row = q0 + tid;
        const long long at = (long long)bh * seq + row;
        row_lse[tid] = row < seq ? p.lse[at] : 0.f;
        row_dd[tid] = row < seq ? p.dd[at] : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int half = 0; half < BQ; half += QH) {
        // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 32 queries
        float s[NQ][4], dp[NQ][4];
#pragma unroll
        for (int n = 0; n < NQ; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int c = kk * 16 + tg * 2;
          const uint32_t ka0 = ld32(&Ks[r0 * LDR + c]), ka1 = ld32(&Ks[(r0 + 8) * LDR + c]);
          const uint32_t ka2 = ld32(&Ks[r0 * LDR + c + 8]);
          const uint32_t ka3 = ld32(&Ks[(r0 + 8) * LDR + c + 8]);
          const uint32_t va0 = ld32(&Vs[r0 * LDR + c]), va1 = ld32(&Vs[(r0 + 8) * LDR + c]);
          const uint32_t va2 = ld32(&Vs[r0 * LDR + c + 8]);
          const uint32_t va3 = ld32(&Vs[(r0 + 8) * LDR + c + 8]);
#pragma unroll
          for (int n = 0; n < NQ; ++n) {
            const bf16* qr = &Qs[(half + n * 8 + g) * LDR + c];
            mma_bf16(s[n], ka0, ka1, ka2, ka3, ld32(qr), ld32(qr + 8));
            const bf16* orr = &Os[(half + n * 8 + g) * LDR + c];
            mma_bf16(dp[n], va0, va1, va2, va3, ld32(orr), ld32(orr + 8));
          }
        }

        // p and ds; element e of n-tile n: key r0 + (e >> 1) * 8, query
        // half + n * 8 + tg * 2 + (e & 1)
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = r0 + (e >> 1) * 8;
            const int qi = half + n * 8 + tg * 2 + (e & 1);
            const int qrow = q0 + qi;
            const bool ok = pm[key] && qrow < seq && (!p.causal || k0 + key <= qrow);
            const float pr = ok ? expf(s[n][e] * p.scale - row_lse[qi]) : 0.f;
            s[n][e] = pr;
            dp[n][e] = pr * (dp[n][e] - row_dd[qi]);
          }
        }

        // dV += round(P)^T dO, dK += round(dS)^T Q over this half's queries
#pragma unroll
        for (int kk = 0; kk < QH / 16; ++kk) {
          const uint32_t pa0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
          const uint32_t pa1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
          const uint32_t pa2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          const uint32_t pa3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
          const uint32_t da0 = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
          const uint32_t da1 = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
          const uint32_t da2 = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
          const uint32_t da3 = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
          const int col = half + kk * 16 + tg * 2;
#pragma unroll
          for (int j = 0; j < NO; ++j) {
            const bf16* orr = &Ot[(j * 8 + g) * LDT + col];
            mma_bf16(dv[j], pa0, pa1, pa2, pa3, ld32(orr), ld32(orr + 8));
            const bf16* qr = &Qt[(j * 8 + g) * LDT + col];
            mma_bf16(dk[j], da0, da1, da2, da3, ld32(qr), ld32(qr + 8));
          }
        }
      }
    }
  }

  bf16* dkg = static_cast<bf16*>(p.dk);
  bf16* dvg = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r0 + r * 8;
    if (key < seq) {
      const long long base = ((long long)bk * seq + key) * HD;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const long long at = base + j * 8 + tg * 2;
        *reinterpret_cast<uint32_t*>(&dkg[at]) =
            pack_bf16(dk[j][2 * r] * p.scale, dk[j][2 * r + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(&dvg[at]) = pack_bf16(dv[j][2 * r], dv[j][2 * r + 1]);
      }
    }
  }
}

// ------------------------------ f32: FMAs ---------------------------------- //

constexpr int LD = 65;  // row pitch (floats) of a transposed [d][64] tile
constexpr int NT = 256;

// rows [r0, r0 + 64) of a [T, HD] slice (row stride st) into dst[HD][LD],
// transposed; rows at or past T read as 0. Consecutive threads take
// consecutive columns: coalesced reads, and stores 65 floats apart, which
// fall in distinct banks.
template <int HD>
__device__ __forceinline__ void load_t(float* dst, const float* src, long long st, int r0,
                                       int seq) {
  for (int e = threadIdx.x; e < 64 * HD; e += NT) {
    const int r = e / HD, c = e - (e / HD) * HD;
    const int row = r0 + r;
    dst[c * LD + r] = row < seq ? src[row * st + c] : 0.f;
  }
}

template <int HD>
constexpr int dq_smem_bytes() {
  // Qt, dOt, Kt, Vt [HD][LD]; dS [BQ][LD]; lse, D [BQ]; key visibility [BK]
  return (4 * HD * LD + BQ * LD + 2 * BQ) * 4 + BK * 4;
}

template <int HD>
constexpr int dkv_smem_bytes() {
  // Kt, Vt, Qt, dOt [HD][LD]; P^T, dS^T [BK][LD]; lse, D [BQ]; visibility [BK]
  return (4 * HD * LD + 2 * BK * LD + 2 * BQ) * 4 + BK * 4;
}

template <int HD>
__global__ void __launch_bounds__(NT) flash_dq_f32_kernel(const Params p) {
  constexpr int RI = BQ / 16;  // query rows per thread
  constexpr int CJ = BK / 16;  // key columns per thread
  constexpr int OJ = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qt = smem;
  float* Ot = Qt + HD * LD;
  float* Kt = Ot + HD * LD;
  float* Vt = Kt + HD * LD;
  float* Ss = Vt + HD * LD;
  float* row_lse = Ss + BQ * LD;
  float* row_dd = row_lse + BQ;
  int* pm = reinterpret_cast<int*>(row_dd + BQ);

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = blockIdx.x * BQ;
  const int seq = p.T;

  const float* kg = static_cast<const float*>(p.k) + b * p.skb + hk * p.skh;
  const float* vg = static_cast<const float*>(p.v) + b * p.svb + hk * p.svh;
  load_t<HD>(Qt, static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh, p.sqt, q0, seq);
  load_t<HD>(Ot, static_cast<const float*>(p.dout) + b * p.sob + h * p.soh, p.sot, q0, seq);
  if (tid < BQ) {
    const int row = q0 + tid;
    const long long at = (long long)bh * seq + row;
    row_lse[tid] = row < seq ? p.lse[at] : 0.f;
    row_dd[tid] = row < seq ? p.dd[at] : 0.f;
  }

  float acc[RI][OJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) acc[i][j] = 0.f;

  const int kv_end = p.causal ? min(seq, q0 + BQ) : seq;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done (and Qt, dOt stored)
    load_t<HD>(Kt, kg, p.skt, k0, seq);
    load_t<HD>(Vt, vg, p.svt, k0, seq);
    if (tid < BK) pm[tid] = key_visible(p, b, k0 + tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this thread's 4 x 4 elements
    float s[RI][CJ], dp[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < HD; ++kk) {
      float qv[RI], ov[RI], kv[CJ], vv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qv[i] = Qt[kk * LD + ty + 16 * i];
        ov[i] = Ot[kk * LD + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        kv[j] = Kt[kk * LD + tx + 16 * j];
        vv[j] = Vt[kk * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      const int qrow = q0 + r;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = tx + 16 * j;
        const bool ok = pm[col] && (!p.causal || k0 + col <= qrow);
        const float pr = ok ? expf(s[i][j] * p.scale - row_lse[r]) : 0.f;
        Ss[r * LD + col] = pr * (dp[i][j] - row_dd[r]);
      }
    }
    __syncthreads();

    // dQ += dS K: K read from its transposed tile, 65 floats apart per thread
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float sv[RI], kv[OJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) sv[i] = Ss[(ty + 16 * i) * LD + kk];
#pragma unroll
      for (int j = 0; j < OJ; ++j) kv[j] = Kt[(tx + 16 * j) * LD + kk];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < OJ; ++j) acc[i][j] = fmaf(sv[i], kv[j], acc[i][j]);
    }
  }

  float* dq = static_cast<float*>(p.dq);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < seq) {
      const long long base = ((long long)bh * seq + row) * HD;
#pragma unroll
      for (int j = 0; j < OJ; ++j) dq[base + tx + 16 * j] = acc[i][j] * p.scale;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(NT) flash_dkv_f32_kernel(const Params p) {
  constexpr int RI = BK / 16;  // key rows per thread
  constexpr int CJ = BQ / 16;  // query columns per thread
  constexpr int OJ = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Kt = smem;
  float* Vt = Kt + HD * LD;
  float* Qt = Vt + HD * LD;
  float* Ot = Qt + HD * LD;
  float* Ps = Ot + HD * LD;  // P^T  [key][query]
  float* Ss = Ps + BK * LD;  // dS^T [key][query]
  float* row_lse = Ss + BK * LD;
  float* row_dd = row_lse + BQ;
  int* pm = reinterpret_cast<int*>(row_dd + BQ);

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int bk = blockIdx.y;
  const int b = bk / p.Hkv;
  const int hk = bk - b * p.Hkv;
  const int rep = p.H / p.Hkv;
  const int k0 = blockIdx.x * BK;
  const int seq = p.T;

  load_t<HD>(Kt, static_cast<const float*>(p.k) + b * p.skb + hk * p.skh, p.skt, k0, seq);
  load_t<HD>(Vt, static_cast<const float*>(p.v) + b * p.svb + hk * p.svh, p.svt, k0, seq);
  if (tid < BK) pm[tid] = key_visible(p, b, k0 + tid);

  float dk[RI][OJ], dv[RI][OJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  // q tiles wholly before this kv tile see none of its keys (causal)
  const int q_start = p.causal ? (k0 / BQ) * BQ : 0;
  for (int h = hk * rep; h < (hk + 1) * rep; ++h) {
    const int bh = b * p.H + h;
    const float* qg = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
    const float* og = static_cast<const float*>(p.dout) + b * p.sob + h * p.soh;
    for (int q0 = q_start; q0 < seq; q0 += BQ) {
      __syncthreads();  // the previous tile's readers are done
      load_t<HD>(Qt, qg, p.sqt, q0, seq);
      load_t<HD>(Ot, og, p.sot, q0, seq);
      if (tid < BQ) {
        const int row = q0 + tid;
        const long long at = (long long)bh * seq + row;
        row_lse[tid] = row < seq ? p.lse[at] : 0.f;
        row_dd[tid] = row < seq ? p.dd[at] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
      float s[RI][CJ], dp[RI][CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < HD; ++kk) {
        float kv[RI], vv[RI], qv[CJ], ov[CJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          kv[i] = Kt[kk * LD + ty + 16 * i];
          vv[i] = Vt[kk * LD + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          qv[j] = Qt[kk * LD + tx + 16 * j];
          ov[j] = Ot[kk * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int key = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int qi = tx + 16 * j;
          const int qrow = q0 + qi;
          const bool ok = pm[key] && qrow < seq && (!p.causal || k0 + key <= qrow);
          const float pr = ok ? expf(s[i][j] * p.scale - row_lse[qi]) : 0.f;
          Ps[key * LD + qi] = pr;
          Ss[key * LD + qi] = pr * (dp[i][j] - row_dd[qi]);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q: dO and Q read from their transposed tiles
#pragma unroll 4
      for (int kk = 0; kk < BQ; ++kk) {
        float pv[RI], sv[RI], ov[OJ], qv[OJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          pv[i] = Ps[(ty + 16 * i) * LD + kk];
          sv[i] = Ss[(ty + 16 * i) * LD + kk];
        }
#pragma unroll
        for (int j = 0; j < OJ; ++j) {
          ov[j] = Ot[(tx + 16 * j) * LD + kk];
          qv[j] = Qt[(tx + 16 * j) * LD + kk];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < OJ; ++j) {
            dv[i][j] = fmaf(pv[i], ov[j], dv[i][j]);
            dk[i][j] = fmaf(sv[i], qv[j], dk[i][j]);
          }
      }
    }
  }

  float* dkg = static_cast<float*>(p.dk);
  float* dvg = static_cast<float*>(p.dv);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key < seq) {
      const long long base = ((long long)bk * seq + key) * HD;
#pragma unroll
      for (int j = 0; j < OJ; ++j) {
        dkg[base + tx + 16 * j] = dk[i][j] * p.scale;
        dvg[base + tx + 16 * j] = dv[i][j];
      }
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, int bytes, dim3 grid, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* dd, const int* mask, void* dq, void* dk,
                   void* dv, int B, int H, int Hkv, int T, const long long* s, int causal,
                   float scale) {
  // s: the (b, h, t) strides of q, k, v and dout, in that order
  return Params{q,    k,    v,    dout, lse,  dd,    mask,  dq,     dk,   dv,   B,    H,
                Hkv,  T,    s[0], s[1], s[2], s[3],  s[4],  s[5],   s[6], s[7], s[8], s[9],
                s[10], s[11], causal, scale};
}

}  // namespace

// strides: 12 values, (b, h, t) strides of q, k, v and dout in that order.
// Each returns a cudaError_t: 0 when the launch was accepted.
extern "C" int flash_attention_dq(const void* q, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* dd, const int* mask, void* dq,
                                  int B, int H, int Hkv, int T, int d, const long long* strides,
                                  int causal, int is_bf16, float scale, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, dd, mask, dq, nullptr, nullptr, B, H, Hkv, T,
                               strides, causal, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + BQ - 1) / BQ, B * H);
  if (is_bf16) {
    if (d == 128)
      return launch(flash_dq_mma_kernel<128>, MMA_NT, dq_mma_smem_bytes<128>(), grid, p, st);
    if (d == 64)
      return launch(flash_dq_mma_kernel<64>, MMA_NT, dq_mma_smem_bytes<64>(), grid, p, st);
  } else {
    if (d == 128) return launch(flash_dq_f32_kernel<128>, NT, dq_smem_bytes<128>(), grid, p, st);
    if (d == 64) return launch(flash_dq_f32_kernel<64>, NT, dq_smem_bytes<64>(), grid, p, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_attention_dkv(const void* q, const void* k, const void* v, const void* dout,
                                   const float* lse, const float* dd, const int* mask, void* dk,
                                   void* dv, int B, int H, int Hkv, int T, int d,
                                   const long long* strides, int causal, int is_bf16, float scale,
                                   void* stream) {
  const Params p = make_params(q, k, v, dout, lse, dd, mask, nullptr, dk, dv, B, H, Hkv, T,
                               strides, causal, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + BK - 1) / BK, B * Hkv);
  if (is_bf16) {
    if (d == 128)
      return launch(flash_dkv_mma_kernel<128>, MMA_NT, dkv_mma_smem_bytes<128>(), grid, p, st);
    if (d == 64)
      return launch(flash_dkv_mma_kernel<64>, MMA_NT, dkv_mma_smem_bytes<64>(), grid, p, st);
  } else {
    if (d == 128)
      return launch(flash_dkv_f32_kernel<128>, NT, dkv_smem_bytes<128>(), grid, p, st);
    if (d == 64) return launch(flash_dkv_f32_kernel<64>, NT, dkv_smem_bytes<64>(), grid, p, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
