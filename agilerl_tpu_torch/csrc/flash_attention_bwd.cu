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
// - dQ: one block per (b, head, 64-row q tile), looping over the kv tiles;
// - dK/dV: one block per (b, kv head, 64-key kv tile), looping over the
//   H / Hkv query heads of its GQA group and, for each, the q tiles. The JAX
//   model repeats K/V before its kernel and jnp.repeat's transpose sums the
//   group; the port passes K/V unrepeated, so the block sums the group
//   itself: deterministic, no atomics.
//
// Two kernels of each, chosen by the input type (as the forward):
// - bf16 (the model's path): wgmma fed by TMA, from the pieces it shares
//   with the forward (csrc/flash_wgmma.cuh). A block is one consumer
//   warpgroup (64 rows of the output tile) and one producer warp. The
//   producer loads the block's resident tiles once (Q and dO for dQ, K and V
//   for dK/dV) and streams the other pair (K, V or Q, dO) through a ring of
//   two stages with full/empty mbarriers (dQ: two blocks an SM; dK/dV: one
//   block an SM, since dK and dV take 128 f32 registers a thread at d = 128
//   and spilled at the 168 that two blocks allow). q, k, v
//   and dO are read as 4-D tensor maps (d, T, heads, B) over the callers'
//   strided [B, H, T, d] views; 64 bf16 make one 128-byte swizzled row, so a
//   d = 128 tile is two [64, 64] boxes, and rows at or past T arrive as
//   zeros. The score-sized products (S = Q K^T and dP = dO V^T for dQ;
//   S^T = K Q^T and dP^T = V dO^T for dK/dV, in two halves of 32 queries to
//   keep the registers of dK and dV) read both operands K-major from shared
//   memory. p and dS go from the accumulator registers, rounded to bf16,
//   straight in as the A operand of the output products (dQ += dS K;
//   dV += P^T dO, dK += dS^T Q), whose B operands (K; dO, Q) are read as
//   stored, MN-major, through wgmma's transpose bit: no transposed copies.
//   Tiles that carry no visible key are skipped. Each block first finds the
//   first visible key of the kv tiles it may meet (one warp ballot per 64
//   keys of the mask; >= T where there is none): a kv tile with no visible
//   key contributes nothing (dK/dV writes zeros, dQ skips it), and under
//   causal masking a q tile whose last row precedes the kv tile's first
//   visible key contributes nothing to it (tests/test_torch_flash_plan.py
//   holds the plain version of this rule and checks it on the CPU).
//   Blocks run longest first: under causal masking the dK/dV blocks of the
//   first kv tile and the dQ blocks of the last q tile meet the most tiles.
// - f32: the products as f32 FMAs (no tensor cores: TF32 would lose the f32
//   inputs' precision), 256 threads in a 16 x 16 grid over tiles staged
//   transposed in shared memory ([d][64 + 1] floats; 32-row tiles at d =
//   256, where four 64-row ones would not fit).
//
// Head dims: built for d = 64, 128 and 256; the wrapper runs any other d <=
// 256 at the next of these on zero-padded copies (see the forward). At d =
// 256 a bf16 block owns half of the output columns (two blocks per tile,
// each recomputing the scores over the whole of d), so that dQ, or dK and
// dV, keep the 64 accumulator registers a thread they take at d = 128.
// Past 256 (any multiple of 64, no upper limit) the column-group kernels
// extend that mechanism: ceil(d / 128) blocks a tile, each recomputing S
// and dP over 64-column chunks of its operands streamed through a ring of
// 32 KB units (the tiles of d = 256's kernels no longer fit beside the
// ring); their dK/dV runs each q tile's two 32-query halves as two passes
// over the chunks (both halves' S and dP beside dK and dV would not fit in
// the registers). They run f32, dQ past d = 512 and dK/dV past d = 1,024.
// The bf16 dQ up to 512 runs a q tile as one block of two warpgroups that
// each own 256 columns of dQ and split the score products by kind (see
// flash_dq_split_kernel); the bf16 dK/dV up to 1,024 runs a kv tile as one
// thread-block cluster of ceil(d / 128) blocks that split d: each computes
// S^T and dP^T over its own 128 columns once, and the cluster adds them
// through distributed shared memory (see flash_dkv_cluster_kernel).
//
// What bounds it on the H100. At the GRPO learn shapes ([16, 32/8, 320, 128]
// bf16) the bytes (q, k, v, dO, lse, D read once; dQ or dK/dV written once)
// take 0.04 ms, the work (6 or 8 flops per visible (q, k) pair and head
// dimension) 0.01-0.02 ms on bf16 tensor cores: memory-bound by the card's
// measure. The bf16 kernels' own limits are the short loops at small T (a
// tile meets at most T / 64 others, so the ring barely fills), the
// serialisation of each tile's two products, and L2 re-reads of the streamed
// tiles by every block that needs them. Past 256 the work bounds (at q, k, v
// [8, 2, 1,024, 512], causal: dQ 0.026 ms, dK/dV 0.035 ms), but the kernels
// are far from it: the column-group kernels compute the score products
// ceil(d / 128) times and re-read their operands from L2 for each group
// (dQ: 272 KB a block per kv tile; dK/dV: 576 KB per q tile). The dQ blocks
// of two warpgroups compute them once, in products of N = 64 that wait for
// each 64-column chunk, and read 320 KB a kv tile at d = 512; the dK/dV
// clusters compute them once and read 32 KB, but each tile then waits on two
// rounds of distributed shared memory copies (~37 KB each way a block at c =
// 4) between its two products. PERF.md holds their times beside the bound.

#include "flash_wgmma.cuh"

namespace {

using namespace flash;

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

// ------------------------------ bf16: wgmma -------------------------------- //

// Output columns a bf16 block owns: all of d up to 128; at d = 256 one half
// (column group), so that dQ (or dK and dV) keep the registers they take at
// d = 128. Each group's block recomputes the scores over the whole of d.
template <int HD>
__host__ __device__ constexpr int out_cols() {
  return HD > 128 ? 128 : HD;
}

template <int HD>
__global__ void __launch_bounds__(WG_NT, HD > 128 ? 1 : 2)
    flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap to, const Params p) {
  constexpr int TB = tile_bytes<HD>();
  constexpr int OD = out_cols<HD>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int nt = (p.T + BQ - 1) / BQ;
  // block order: the q tile slowest, then b, then the head (a GQA group's
  // heads side by side), then the column group; under causal masking the
  // last q tile, which meets the most kv tiles, first
  const int cg = blockIdx.x % (HD / OD);
  const int blk = blockIdx.x / (HD / OD);
  const int slot = blk / (p.B * p.H);
  const int qt = p.causal ? nt - 1 - slot : slot;
  const int b = blk / p.H % p.B;
  const int h = blk % p.H;
  const int q0 = qt * BQ;
  const int hk = h / (p.H / p.Hkv);
  // kv tile kt carries a visible key for some row of this q tile iff its
  // first visible key is at most limit; causal: kv tiles past qt never do
  const int limit = p.causal ? min(q0 + BQ - 1, p.T - 1) : p.T - 1;
  const int kt_end = p.causal ? qt + 1 : nt;
  const Smem<HD, 2> sm = smem_setup<HD, 2>(smem_raw, p.mask, p.T, b, 0, kt_end);
  const int* first = sm.first;

  if (threadIdx.x >= NCONS) {  // producer warp: one thread issues every load
    if (threadIdx.x == NCONS) {
      mbar_expect_tx(sm.res_bar(), 2 * TB);
      load_tile<HD>(sm.res(0), &tq, sm.res_bar(), q0, h, b);
      load_tile<HD>(sm.res(1), &to, sm.res_bar(), q0, h, b);
      Pipe pipe;
      for (int kt = 0; kt < kt_end; ++kt) {
        if (first[kt] > limit) continue;
        mbar_wait(sm.empty(pipe.stage), pipe.phase ^ 1u);
        const uint32_t full = sm.full(pipe.stage), s = sm.stage(pipe.stage);
        mbar_expect_tx(full, 2 * TB);
        load_tile<HD>(s, &tk, full, kt * BK, hk, b);
        load_tile<HD>(s + TB, &tv, full, kt * BK, hk, b);
        pipe.advance();
      }
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2);  // this thread's rows r0, r0 + 8 of the tile
  const int c0 = (lane & 3) * 2;           // and its column pairs c0 + 8 n
  const long long bh = (long long)b * p.H + h;
  int qrow[2];
  float lse_r[2], dd_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qrow[i] = q0 + r0 + 8 * i;
    const bool real = qrow[i] < p.T;
    lse_r[i] = real ? p.lse[bh * p.T + qrow[i]] : 0.f;
    dd_r[i] = real ? p.dd[bh * p.T + qrow[i]] : 0.f;
  }
  float acc[OD / 2];
#pragma unroll
  for (int j = 0; j < OD / 2; ++j) acc[j] = 0.f;

  mbar_wait(sm.res_bar(), 0);
  Pipe pipe;
  for (int kt = 0; kt < kt_end; ++kt) {
    if (first[kt] > limit) continue;
    const int k0 = kt * BK;
    unsigned vis = 0;  // this thread's 16 key columns: 8 n + c0 + e at bit 2 n + e
#pragma unroll
    for (int i = 0; i < 16; ++i)
      vis |= (unsigned)key_visible(p.mask, p.T, b, k0 + (i >> 1) * 8 + c0 + (i & 1)) << i;
    mbar_wait(sm.full(pipe.stage), pipe.phase);
    const uint32_t ks = sm.stage(pipe.stage), vs = ks + TB;

    // S = Q K^T and dP = dO V^T: 64 q rows x 64 keys, K-major operands
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = kmajor_step(kk);
      wgmma_ss(s, desc_sw128(sm.res(0) + off), desc_sw128(ks + off), kk > 0);
      wgmma_ss(dp, desc_sw128(sm.res(1) + off), desc_sw128(vs + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);

    // dS = p (dP - D) in place of s; j = 4 n + 2 i + e is row r0 + 8 i,
    // column 8 n + c0 + e
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int i = (j >> 1) & 1;
      const int col = (j >> 2) * 8 + c0 + (j & 1);
      const bool ok =
          ((vis >> (2 * (j >> 2) + (j & 1))) & 1u) && (!p.causal || k0 + col <= qrow[i]);
      const float pr = ok ? expf(s[j] * p.scale - lse_r[i]) : 0.f;
      s[j] = pr * (dp[j] - dd_r[i]);
    }

    // dQ += round(dS) K: K read as stored ([keys][HD]: MN-major), 16 keys a
    // step, from the column group's first box
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(a[kk], s, kk);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, a[kk], desc_sw128_mn(ks + cg * (OD / 64) * BOX + kk * 2048, BOX), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    mbar_arrive(sm.empty(pipe.stage));
    pipe.advance();
  }

  bf16* dq = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qrow[i] < p.T) {
      const long long at = (bh * p.T + qrow[i]) * HD + cg * OD + c0;
#pragma unroll
      for (int n = 0; n < OD / 8; ++n)
        *reinterpret_cast<uint32_t*>(&dq[at + n * 8]) =
            pack_bf16(acc[4 * n + 2 * i] * p.scale, acc[4 * n + 2 * i + 1] * p.scale);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(WG_NT, 1)
    flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap to, const Params p) {
  constexpr int TB = tile_bytes<HD>();
  constexpr int OD = out_cols<HD>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int nt = (p.T + BK - 1) / BK;
  // block order: the kv tile slowest, then b, then the kv head, then the
  // column group; under causal masking the first kv tile, which meets the
  // most q tiles, first
  const int cg = blockIdx.x % (HD / OD);
  const int blk = blockIdx.x / (HD / OD);
  const int kt = blk / (p.B * p.Hkv);
  const int b = blk / p.Hkv % p.B;
  const int hk = blk % p.Hkv;
  const int k0 = kt * BK;
  const int rep = p.H / p.Hkv;
  const long long bk = (long long)b * p.Hkv + hk;
  const Smem<HD, 2> sm = smem_setup<HD, 2>(smem_raw, p.mask, p.T, b, kt, kt + 1);
  const int f = sm.first[kt];

  if (f >= p.T) {  // no visible key in this kv tile: dK = dV = 0
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    const int rows = min(BK, p.T - k0);
    for (int e = threadIdx.x; e < rows * (OD / 8); e += WG_NT) {
      const long long at =
          (bk * p.T + k0 + e / (OD / 8)) * HD + cg * OD + (e % (OD / 8)) * 8;
      *reinterpret_cast<uint4*>(static_cast<bf16*>(p.dk) + at) = zero;
      *reinterpret_cast<uint4*>(static_cast<bf16*>(p.dv) + at) = zero;
    }
    return;
  }
  // q tiles before the one that holds key f see no key of this tile (causal)
  const int qt0 = p.causal ? f / BQ : 0;

  if (threadIdx.x >= NCONS) {  // producer warp: one thread issues every load
    if (threadIdx.x == NCONS) {
      mbar_expect_tx(sm.res_bar(), 2 * TB);
      load_tile<HD>(sm.res(0), &tk, sm.res_bar(), k0, hk, b);
      load_tile<HD>(sm.res(1), &tv, sm.res_bar(), k0, hk, b);
      Pipe pipe;
      for (int h = hk * rep; h < (hk + 1) * rep; ++h) {
        for (int qt = qt0; qt < nt; ++qt) {
          mbar_wait(sm.empty(pipe.stage), pipe.phase ^ 1u);
          const uint32_t full = sm.full(pipe.stage), s = sm.stage(pipe.stage);
          mbar_expect_tx(full, 2 * TB);
          load_tile<HD>(s, &tq, full, qt * BQ, h, b);
          load_tile<HD>(s + TB, &to, full, qt * BQ, h, b);
          pipe.advance();
        }
      }
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2);  // this thread's keys k0 + r0, k0 + r0 + 8
  const int c0 = (lane & 3) * 2;
  int key[2], kvis[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = k0 + r0 + 8 * i;
    kvis[i] = key_visible(p.mask, p.T, b, key[i]);
  }
  float dk[OD / 2], dv[OD / 2];
#pragma unroll
  for (int j = 0; j < OD / 2; ++j) dk[j] = dv[j] = 0.f;

  mbar_wait(sm.res_bar(), 0);
  Pipe pipe;
  for (int h = hk * rep; h < (hk + 1) * rep; ++h) {
    const float* lse = p.lse + ((long long)b * p.H + h) * p.T;
    const float* ddh = p.dd + ((long long)b * p.H + h) * p.T;
    for (int qt = qt0; qt < nt; ++qt) {
      const int q0 = qt * BQ;
      mbar_wait(sm.full(pipe.stage), pipe.phase);
      const uint32_t qs = sm.stage(pipe.stage), os = qs + TB;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // this thread's 8 query columns: half * 32 + 8 n + c0 + e at 2 n + e
        float lq[8], dq_[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int q = q0 + half * 32 + (i >> 1) * 8 + c0 + (i & 1);
          lq[i] = q < p.T ? lse[q] : 0.f;
          dq_[i] = q < p.T ? ddh[q] : 0.f;
        }
        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 32 queries, K-major operands
        float s[16], dp[16];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = kmajor_step(kk);
          wgmma_ss(s, desc_sw128(sm.res(0) + off), desc_sw128(qs + half * 32 * 128 + off),
                   kk > 0);
          wgmma_ss(dp, desc_sw128(sm.res(1) + off), desc_sw128(os + half * 32 * 128 + off),
                   kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(s);
        fence_acc(dp);

        // P^T and dS^T; j = 4 n + 2 i + e is key r0 + 8 i, query column 8 n + c0 + e
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int i = (j >> 1) & 1;
          const int col = 2 * (j >> 2) + (j & 1);
          const int q = q0 + half * 32 + (j >> 2) * 8 + c0 + (j & 1);
          const bool ok = kvis[i] && q < p.T && (!p.causal || key[i] <= q);
          const float pr = ok ? expf(s[j] * p.scale - lq[col]) : 0.f;
          s[j] = pr;
          dp[j] = pr * (dp[j] - dq_[col]);
        }

        // dV += round(P^T) dO and dK += round(dS^T) Q: dO and Q read as
        // stored ([queries][HD]: MN-major), 16 queries a step, from the
        // column group's first box
        uint32_t pa[2][4], da[2][4];
#pragma unroll
        for (int kq = 0; kq < 2; ++kq) {
          acc_to_a(pa[kq], s, kq);
          acc_to_a(da[kq], dp, kq);
        }
        fence_acc(dv);
        fence_acc(dk);
        wgmma_fence();
#pragma unroll
        for (int kq = 0; kq < 2; ++kq) {
          const uint32_t off = cg * (OD / 64) * BOX + (half * 32 + kq * 16) * 128;
          wgmma_rs(dv, pa[kq], desc_sw128_mn(os + off, BOX), 1);
          wgmma_rs(dk, da[kq], desc_sw128_mn(qs + off, BOX), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(dv);
        fence_acc(dk);
      }
      mbar_arrive(sm.empty(pipe.stage));
      pipe.advance();
    }
  }

  bf16* dkg = static_cast<bf16*>(p.dk);
  bf16* dvg = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] < p.T) {
      const long long at = (bk * p.T + key[i]) * HD + cg * OD + c0;
#pragma unroll
      for (int n = 0; n < OD / 8; ++n) {
        const int j = 4 * n + 2 * i;
        *reinterpret_cast<uint32_t*>(&dkg[at + n * 8]) =
            pack_bf16(dk[j] * p.scale, dk[j + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(&dvg[at + n * 8]) = pack_bf16(dv[j], dv[j + 1]);
      }
    }
  }
}

// ------------------------------ f32: FMAs ---------------------------------- //

constexpr int NT = 256;

// Rows R of a tile: 64, and 32 at d = 256, where four [d][65] tiles would
// not fit in shared memory. A transposed [d][R] tile has a row pitch of
// LD = R + 1 floats.
template <int HD>
__host__ __device__ constexpr int f32_rows() {
  return HD > 128 ? 32 : 64;
}

// rows [r0, r0 + R) of a [T, HD] slice (row stride st) into dst[HD][R + 1],
// transposed; rows at or past T read as 0. Consecutive threads take
// consecutive columns: coalesced reads, and stores R + 1 floats apart (an
// odd pitch), which fall in distinct banks.
template <int HD, int R>
__device__ __forceinline__ void load_t(float* dst, const float* src, long long st, int r0,
                                       int seq) {
  constexpr int LD = R + 1;
  for (int e = threadIdx.x; e < R * HD; e += NT) {
    const int r = e / HD, c = e - (e / HD) * HD;
    const int row = r0 + r;
    dst[c * LD + r] = row < seq ? src[row * st + c] : 0.f;
  }
}

template <int HD>
constexpr int dq_smem_bytes() {
  // Qt, dOt, Kt, Vt [HD][LD]; dS [R][LD]; lse, D [R]; key visibility [R]
  constexpr int R = f32_rows<HD>(), LD = R + 1;
  return (4 * HD * LD + R * LD + 2 * R) * 4 + R * 4;
}

template <int HD>
constexpr int dkv_smem_bytes() {
  // Kt, Vt, Qt, dOt [HD][LD]; P^T, dS^T [R][LD]; lse, D [R]; visibility [R]
  constexpr int R = f32_rows<HD>(), LD = R + 1;
  return (4 * HD * LD + 2 * R * LD + 2 * R) * 4 + R * 4;
}

template <int HD>
__global__ void __launch_bounds__(NT) flash_dq_f32_kernel(const Params p) {
  constexpr int R = f32_rows<HD>(), LD = R + 1;
  constexpr int RI = R / 16;  // query rows per thread
  constexpr int CJ = R / 16;  // key columns per thread
  constexpr int OJ = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qt = smem;
  float* Ot = Qt + HD * LD;
  float* Kt = Ot + HD * LD;
  float* Vt = Kt + HD * LD;
  float* Ss = Vt + HD * LD;
  float* row_lse = Ss + R * LD;
  float* row_dd = row_lse + R;
  int* pm = reinterpret_cast<int*>(row_dd + R);

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = blockIdx.x * R;
  const int seq = p.T;

  const float* kg = static_cast<const float*>(p.k) + b * p.skb + hk * p.skh;
  const float* vg = static_cast<const float*>(p.v) + b * p.svb + hk * p.svh;
  load_t<HD, R>(Qt, static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh, p.sqt, q0, seq);
  load_t<HD, R>(Ot, static_cast<const float*>(p.dout) + b * p.sob + h * p.soh, p.sot, q0, seq);
  if (tid < R) {
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

  const int kv_end = p.causal ? min(seq, q0 + R) : seq;
  for (int k0 = 0; k0 < kv_end; k0 += R) {
    __syncthreads();  // the previous tile's readers are done (and Qt, dOt stored)
    load_t<HD, R>(Kt, kg, p.skt, k0, seq);
    load_t<HD, R>(Vt, vg, p.svt, k0, seq);
    if (tid < R) pm[tid] = key_visible(p.mask, p.T, b, k0 + tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this thread's RI x CJ elements
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

    // dQ += dS K: K read from its transposed tile, LD floats apart per thread
#pragma unroll 4
    for (int kk = 0; kk < R; ++kk) {
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
  constexpr int R = f32_rows<HD>(), LD = R + 1;
  constexpr int RI = R / 16;  // key rows per thread
  constexpr int CJ = R / 16;  // query columns per thread
  constexpr int OJ = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Kt = smem;
  float* Vt = Kt + HD * LD;
  float* Qt = Vt + HD * LD;
  float* Ot = Qt + HD * LD;
  float* Ps = Ot + HD * LD;  // P^T  [key][query]
  float* Ss = Ps + R * LD;  // dS^T [key][query]
  float* row_lse = Ss + R * LD;
  float* row_dd = row_lse + R;
  int* pm = reinterpret_cast<int*>(row_dd + R);

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int bk = blockIdx.y;
  const int b = bk / p.Hkv;
  const int hk = bk - b * p.Hkv;
  const int rep = p.H / p.Hkv;
  const int k0 = blockIdx.x * R;
  const int seq = p.T;

  load_t<HD, R>(Kt, static_cast<const float*>(p.k) + b * p.skb + hk * p.skh, p.skt, k0, seq);
  load_t<HD, R>(Vt, static_cast<const float*>(p.v) + b * p.svb + hk * p.svh, p.svt, k0, seq);
  if (tid < R) pm[tid] = key_visible(p.mask, p.T, b, k0 + tid);

  float dk[RI][OJ], dv[RI][OJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  // q tiles wholly before this kv tile see none of its keys (causal)
  const int q_start = p.causal ? (k0 / R) * R : 0;
  for (int h = hk * rep; h < (hk + 1) * rep; ++h) {
    const int bh = b * p.H + h;
    const float* qg = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
    const float* og = static_cast<const float*>(p.dout) + b * p.sob + h * p.soh;
    for (int q0 = q_start; q0 < seq; q0 += R) {
      __syncthreads();  // the previous tile's readers are done
      load_t<HD, R>(Qt, qg, p.sqt, q0, seq);
      load_t<HD, R>(Ot, og, p.sot, q0, seq);
      if (tid < R) {
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
      for (int kk = 0; kk < R; ++kk) {
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

// --------------------- wide head dims (d > 256): both types ----------------- //
//
// As at d = 256, a block owns one column group of its output (OD = 128
// columns of dQ, or of dK and dV), so the accumulators keep the registers
// they take at d = 128, and recomputes the score-sized products (S and dP)
// over the whole of d. Past 256 the operand tiles no longer fit in shared
// memory beside the ring, so those products are accumulated over 64-column
// chunks of their operands streamed through it, and the group's columns of
// the output products' B operands come as a unit of their own. These run
// f32, dQ past DQ_SPLIT_MAX_D and dK/dV past CL_MAX_D; the bf16 dQ up to
// DQ_SPLIT_MAX_D and dK/dV up to CL_MAX_D run as below.

constexpr int WIDE_OD = 128;  // output columns a backward block owns

// bf16 dQ: per kv tile, units of (Q, dO, K, V) chunk c, then the group's
// columns of K (nb boxes; past d none is loaded, and the accumulator columns
// they would feed are never stored).
__global__ void __launch_bounds__(WG_NT, 1)
    flash_dq_wide_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap to, const Params p, int d) {
  constexpr int OD = WIDE_OD;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int nc = d / 64;
  const int ng = (d + OD - 1) / OD;
  const int nt = (p.T + BQ - 1) / BQ;
  const int cg = blockIdx.x % ng;
  const int blk = blockIdx.x / ng;
  const int slot = blk / (p.B * p.H);
  const int qt = p.causal ? nt - 1 - slot : slot;
  const int b = blk / p.H % p.B;
  const int h = blk % p.H;
  const int q0 = qt * BQ;
  const int hk = h / (p.H / p.Hkv);
  const int limit = p.causal ? min(q0 + BQ - 1, p.T - 1) : p.T - 1;
  const int kt_end = p.causal ? qt + 1 : nt;
  const int nb = min(OD / 64, nc - cg * (OD / 64));
  const Ring ring = ring_setup(smem_raw, p.mask, p.T, b, 0, kt_end);
  const int* first = ring.first;

  if (threadIdx.x >= NCONS) {  // producer warp: one thread issues every load
    if (threadIdx.x == NCONS) {
      WPipe pipe;
      for (int kt = 0; kt < kt_end; ++kt) {
        if (first[kt] > limit) continue;
        for (int c = 0; c < nc; ++c) {
          const BoxLoad l4[4] = {{&tq, c * 64, q0, h}, {&to, c * 64, q0, h},
                                 {&tk, c * 64, kt * BK, hk}, {&tv, c * 64, kt * BK, hk}};
          feed(ring, pipe, l4, 4, b);
        }
        BoxLoad kl[OD / 64];
#pragma unroll
        for (int i = 0; i < OD / 64; ++i)
          kl[i] = BoxLoad{&tk, (cg * (OD / 64) + i) * 64, kt * BK, hk};
        feed(ring, pipe, kl, nb, b);
      }
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2);
  const int c0 = (lane & 3) * 2;
  const long long bh = (long long)b * p.H + h;
  int qrow[2];
  float lse_r[2], dd_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qrow[i] = q0 + r0 + 8 * i;
    const bool real = qrow[i] < p.T;
    lse_r[i] = real ? p.lse[bh * p.T + qrow[i]] : 0.f;
    dd_r[i] = real ? p.dd[bh * p.T + qrow[i]] : 0.f;
  }
  float acc[OD / 2];
#pragma unroll
  for (int j = 0; j < OD / 2; ++j) acc[j] = 0.f;

  WPipe pipe;
  for (int kt = 0; kt < kt_end; ++kt) {
    if (first[kt] > limit) continue;
    const int k0 = kt * BK;
    unsigned vis = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      vis |= (unsigned)key_visible(p.mask, p.T, b, k0 + (i >> 1) * 8 + c0 + (i & 1)) << i;

    // S = Q K^T and dP = dO V^T over the chunks of d
    float s[32], dp[32];
    for (int c = 0; c < nc; ++c) {
      mbar_wait(ring.full(pipe.stage), pipe.phase);
      const uint32_t u = ring.unit(pipe.stage);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss(s, desc_sw128(u + kk * 32), desc_sw128(u + 2 * BOX + kk * 32), c > 0 || kk > 0);
        wgmma_ss(dp, desc_sw128(u + BOX + kk * 32), desc_sw128(u + 3 * BOX + kk * 32),
                 c > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dp);
      mbar_arrive(ring.empty(pipe.stage));
      pipe.advance();
    }

#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int i = (j >> 1) & 1;
      const int col = (j >> 2) * 8 + c0 + (j & 1);
      const bool ok =
          ((vis >> (2 * (j >> 2) + (j & 1))) & 1u) && (!p.causal || k0 + col <= qrow[i]);
      const float pr = ok ? expf(s[j] * p.scale - lse_r[i]) : 0.f;
      s[j] = pr * (dp[j] - dd_r[i]);
    }

    // dQ += round(dS) K over the group's columns (K read as stored)
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(a[kk], s, kk);
    mbar_wait(ring.full(pipe.stage), pipe.phase);
    const uint32_t ks = ring.unit(pipe.stage);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, a[kk], desc_sw128_mn(ks + kk * 2048, BOX), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    fence_a(a);
    mbar_arrive(ring.empty(pipe.stage));
    pipe.advance();
  }

  bf16* dq = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qrow[i] < p.T) {
      const long long at = (bh * p.T + qrow[i]) * d;
#pragma unroll
      for (int n = 0; n < OD / 8; ++n) {
        const int col = cg * OD + n * 8 + c0;
        if (col < d)
          *reinterpret_cast<uint32_t*>(&dq[at + col]) =
              pack_bf16(acc[4 * n + 2 * i] * p.scale, acc[4 * n + 2 * i + 1] * p.scale);
      }
    }
  }
}

// bf16 dK/dV: per (query head of the group, q tile, half of 32 queries),
// units of (K, V, Q, dO) chunk c, then the group's columns of Q and dO (Q at
// boxes 0-1, dO at 2-3 of the unit).
__global__ void __launch_bounds__(WG_NT, 1)
    flash_dkv_wide_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap to, const Params p, int d) {
  constexpr int OD = WIDE_OD;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int nc = d / 64;
  const int ng = (d + OD - 1) / OD;
  const int nt = (p.T + BK - 1) / BK;
  const int cg = blockIdx.x % ng;
  const int blk = blockIdx.x / ng;
  const int kt = blk / (p.B * p.Hkv);
  const int b = blk / p.Hkv % p.B;
  const int hk = blk % p.Hkv;
  const int k0 = kt * BK;
  const int rep = p.H / p.Hkv;
  const long long bk = (long long)b * p.Hkv + hk;
  const int nb = min(OD / 64, nc - cg * (OD / 64));
  const int cols = nb * 64;  // the group's columns below d
  const Ring ring = ring_setup(smem_raw, p.mask, p.T, b, kt, kt + 1);
  const int f = ring.first[kt];

  if (f >= p.T) {  // no visible key in this kv tile: dK = dV = 0
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    const int rows = min(BK, p.T - k0);
    for (int e = threadIdx.x; e < rows * (cols / 8); e += WG_NT) {
      const long long at = (bk * p.T + k0 + e / (cols / 8)) * d + cg * OD + (e % (cols / 8)) * 8;
      *reinterpret_cast<uint4*>(static_cast<bf16*>(p.dk) + at) = zero;
      *reinterpret_cast<uint4*>(static_cast<bf16*>(p.dv) + at) = zero;
    }
    return;
  }
  const int qt0 = p.causal ? f / BQ : 0;

  if (threadIdx.x >= NCONS) {  // producer warp: one thread issues every load
    if (threadIdx.x == NCONS) {
      WPipe pipe;
      for (int h = hk * rep; h < (hk + 1) * rep; ++h) {
        for (int qt = qt0; qt < nt; ++qt) {
          for (int half = 0; half < 2; ++half) {
            for (int c = 0; c < nc; ++c) {
              const BoxLoad l4[4] = {{&tk, c * 64, k0, hk}, {&tv, c * 64, k0, hk},
                                     {&tq, c * 64, qt * BQ, h}, {&to, c * 64, qt * BQ, h}};
              feed(ring, pipe, l4, 4, b);
            }
            BoxLoad ql[2 * (OD / 64)];
#pragma unroll
            for (int i = 0; i < OD / 64; ++i) {
              const int col = (cg * (OD / 64) + i) * 64;
              ql[i] = BoxLoad{&tq, col, qt * BQ, h};
              ql[OD / 64 + i] = BoxLoad{&to, col, qt * BQ, h};
            }
            if (nb < OD / 64) ql[nb] = ql[OD / 64];  // one box each: dO follows Q's
            feed(ring, pipe, ql, 2 * nb, b);
          }
        }
      }
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2);
  const int c0 = (lane & 3) * 2;
  int key[2], kvis[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = k0 + r0 + 8 * i;
    kvis[i] = key_visible(p.mask, p.T, b, key[i]);
  }
  float dk[OD / 2], dv[OD / 2];
#pragma unroll
  for (int j = 0; j < OD / 2; ++j) dk[j] = dv[j] = 0.f;
  // where the group's dO columns start in its unit (right after Q's)
  const uint32_t o_at = nb * BOX;

  WPipe pipe;
  for (int h = hk * rep; h < (hk + 1) * rep; ++h) {
    const float* lse = p.lse + ((long long)b * p.H + h) * p.T;
    const float* ddh = p.dd + ((long long)b * p.H + h) * p.T;
    for (int qt = qt0; qt < nt; ++qt) {
      const int q0 = qt * BQ;
      for (int half = 0; half < 2; ++half) {
        float lq[8], dq_[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int q = q0 + half * 32 + (i >> 1) * 8 + c0 + (i & 1);
          lq[i] = q < p.T ? lse[q] : 0.f;
          dq_[i] = q < p.T ? ddh[q] : 0.f;
        }
        // S^T = K Q^T and dP^T = V dO^T over the chunks of d: 64 keys x 32 queries
        float s[16], dp[16];
        for (int c = 0; c < nc; ++c) {
          mbar_wait(ring.full(pipe.stage), pipe.phase);
          const uint32_t u = ring.unit(pipe.stage);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_ss(s, desc_sw128(u + kk * 32),
                     desc_sw128(u + 2 * BOX + half * 32 * 128 + kk * 32), c > 0 || kk > 0);
            wgmma_ss(dp, desc_sw128(u + BOX + kk * 32),
                     desc_sw128(u + 3 * BOX + half * 32 * 128 + kk * 32), c > 0 || kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(s);
          fence_acc(dp);
          mbar_arrive(ring.empty(pipe.stage));
          pipe.advance();
        }

#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int i = (j >> 1) & 1;
          const int col = 2 * (j >> 2) + (j & 1);
          const int q = q0 + half * 32 + (j >> 2) * 8 + c0 + (j & 1);
          const bool ok = kvis[i] && q < p.T && (!p.causal || key[i] <= q);
          const float pr = ok ? expf(s[j] * p.scale - lq[col]) : 0.f;
          s[j] = pr;
          dp[j] = pr * (dp[j] - dq_[col]);
        }

        // dV += round(P^T) dO and dK += round(dS^T) Q over the group's columns
        uint32_t pa[2][4], da[2][4];
#pragma unroll
        for (int kq = 0; kq < 2; ++kq) {
          acc_to_a(pa[kq], s, kq);
          acc_to_a(da[kq], dp, kq);
        }
        mbar_wait(ring.full(pipe.stage), pipe.phase);
        const uint32_t u = ring.unit(pipe.stage);
        fence_acc(dv);
        fence_acc(dk);
        wgmma_fence();
#pragma unroll
        for (int kq = 0; kq < 2; ++kq) {
          const uint32_t off = (half * 32 + kq * 16) * 128;
          wgmma_rs(dv, pa[kq], desc_sw128_mn(u + o_at + off, BOX), 1);
          wgmma_rs(dk, da[kq], desc_sw128_mn(u + off, BOX), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(dv);
        fence_acc(dk);
#pragma unroll
        for (int kq = 0; kq < 2; ++kq)
#pragma unroll
          for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(pa[kq][i]), "+r"(da[kq][i])::"memory");
        mbar_arrive(ring.empty(pipe.stage));
        pipe.advance();
      }
    }
  }

  bf16* dkg = static_cast<bf16*>(p.dk);
  bf16* dvg = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] < p.T) {
      const long long at = (bk * p.T + key[i]) * d;
#pragma unroll
      for (int n = 0; n < OD / 8; ++n) {
        const int col = cg * OD + n * 8 + c0;
        if (col < d) {
          const int j = 4 * n + 2 * i;
          *reinterpret_cast<uint32_t*>(&dkg[at + col]) =
              pack_bf16(dk[j] * p.scale, dk[j + 1] * p.scale);
          *reinterpret_cast<uint32_t*>(&dvg[at + col]) = pack_bf16(dv[j], dv[j + 1]);
        }
      }
    }
  }
}

// ------------ shared-memory, named-barrier and cluster helpers ------------- //

// This block's rank in its cluster.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

// Every thread of every block of the cluster (divergent warps allowed):
// writes before it are seen by reads after it in any block of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;" ::: "memory");  // release, acquire
}

// The address in block `rank`'s shared memory of this block's shared address a.
__device__ __forceinline__ uint32_t cluster_map(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// A bulk copy of `bytes` (a multiple of 16) from this block's shared memory
// to a cluster address (from cluster_map), completing on the mbarrier at the
// cluster address `bar` of the same block (async proxy: the source's writes
// need fence_proxy_async first).
__device__ __forceinline__ void bulk_to_cluster(uint32_t dst, uint32_t src, uint32_t bytes,
                                                uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Orders this thread's shared-memory writes before later async-proxy reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Named barrier `id` (1 ..) over `n` threads.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// The consumer warpgroup's barrier (named barrier 1; the producer warp is not in it).
__device__ __forceinline__ void consumers_sync() { bar_sync(1, NCONS); }

__device__ __forceinline__ float4 ld_shared_f4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_u2(uint32_t a, uint32_t x, uint32_t y) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};" ::"r"(a), "r"(x), "r"(y) : "memory");
}

__device__ __forceinline__ void st_shared_f2(uint32_t a, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(a), "f"(x), "f"(y) : "memory");
}

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}

// ------- bf16 dQ, 256 < d <= DQ_SPLIT_MAX_D: two warpgroups split the output ------- //
//
// A q tile is one block of two warpgroups. Up to d = 512, dQ's 64 rows x d
// f32 accumulator fits in half of the SM's registers: warpgroup w owns
// columns [256 w, 256 w + 256) of dQ (128 registers a thread). For each
// visible kv tile the block streams units of the (Q, dO, K, V) chunks of 64
// columns (as the column-group kernel), then K's columns of each
// warpgroup's output (a unit each). The score products are split by kind,
// not by columns: warpgroup 0 accumulates S = Q K^T and warpgroup 1 dP =
// dO V^T over all of d, at the same time, so each is computed once per
// tile. Warpgroup 0 hands S to warpgroup 1 through shared memory (each
// thread's 32 accumulator values, thread by thread: the two warpgroups'
// threads hold the same rows and columns), warpgroup 1 applies the dS rule
// and hands dS back as packed bf16 A fragments, and each warpgroup adds
// round(dS) K over its own columns. A block reads (4 nc + nc) x 8 KB from
// L2 per kv tile (nc = d / 64: 320 KB at d = 512) against (4 nc + 2) x 8
// KB for each of the column-group kernel's ceil(d / 128) blocks, and
// exchanges 24 KB through its own shared memory. There is no producer
// warp: with one, ptxas holds every thread to 168 registers and the
// accumulators spill; thread 0 issues the loads instead, refilling a unit's
// slot once both warpgroups have freed it (neither warpgroup frees a unit
// late for want of the other). Past DQ_SPLIT_MAX_D the accumulator no
// longer fits, and the column-group kernel above runs.

constexpr int DQ_SPLIT_MAX_D = 512;
constexpr int DQ_SPLIT_NT = 2 * NCONS;

// alignment slack; the ring; its full / empty barriers; the first visible
// key of each kv tile; S as [32][NCONS] floats; dS as [16][NCONS] packed
// bf16 pairs
constexpr int dq_split_smem_bytes(int nt) {
  return 1024 + WSTAGES * WUNIT * BOX + 2 * WSTAGES * 8 + 4 * nt + 16 + (32 + 16) * NCONS * 4;
}

__global__ void __launch_bounds__(DQ_SPLIT_NT, 1)
    flash_dq_split_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap to, const Params p, int d) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int nc = d / 64;
  const int nt = (p.T + BQ - 1) / BQ;
  // block order: the q tile slowest, then b, then the head; under causal
  // masking the last q tile, which meets the most kv tiles, first
  const int slot = blockIdx.x / (p.B * p.H);
  const int qt = p.causal ? nt - 1 - slot : slot;
  const int b = blockIdx.x / p.H % p.B;
  const int h = blockIdx.x % p.H;
  const int q0 = qt * BQ;
  const int hk = h / (p.H / p.Hkv);
  const int limit = p.causal ? min(q0 + BQ - 1, p.T - 1) : p.T - 1;
  const int kt_end = p.causal ? qt + 1 : nt;

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  Ring ring{base, nullptr};
  ring.first = reinterpret_cast<int*>(smem_raw + (ring.full(2 * WSTAGES) - smem_u32(smem_raw)));
  const uint32_t sx = (ring.full(2 * WSTAGES) + 4 * nt + 15u) & ~15u;  // S, [32][NCONS]
  const uint32_t dsx = sx + 32 * NCONS * 4;                            // dS, [16][NCONS]
  if (threadIdx.x == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(ring.full(s), 1);
      mbar_init(ring.empty(s), 2 * NCONS);  // both warpgroups free every unit
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int kt = (int)(threadIdx.x >> 5); kt < kt_end; kt += DQ_SPLIT_NT / 32)
    ring.first[kt] = first_visible_key(p.mask, p.T, b, kt * BK);
  __syncthreads();
  const int* first = ring.first;

  // thread 0's load cursor: unit pu (nc score units, then 2 output units)
  // of visible kv tile pkt; `issued` units so far
  WPipe ppipe;
  int pkt = 0, pu = 0, issued = 0;
  while (pkt < kt_end && first[pkt] > limit) ++pkt;
  auto produce = [&](int want) {  // issue units until `want` have been
    while (issued < want && pkt < kt_end) {
      if (pu < nc) {
        const BoxLoad l4[4] = {{&tq, pu * 64, q0, h}, {&to, pu * 64, q0, h},
                               {&tk, pu * 64, pkt * BK, hk}, {&tv, pu * 64, pkt * BK, hk}};
        feed(ring, ppipe, l4, 4, b);
      } else {  // warpgroup g's columns of K
        const int g = pu - nc;
        BoxLoad kl[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) kl[i] = BoxLoad{&tk, (4 * g + i) * 64, pkt * BK, hk};
        feed(ring, ppipe, kl, g == 0 ? 4 : nc - 4, b);
      }
      ++issued;
      if (++pu == nc + 2) {
        pu = 0;
        for (++pkt; pkt < kt_end && first[pkt] > limit; ++pkt) {
        }
      }
    }
  };

  const int wg = threadIdx.x / NCONS, t = threadIdx.x % NCONS;
  const int warp = t >> 5, lane = t & 31;
  const int r0 = warp * 16 + (lane >> 2);  // this thread's rows r0, r0 + 8 of the tile
  const int c0 = (lane & 3) * 2;           // and its column pairs c0 + 8 n
  const int nbox = wg == 0 ? 4 : nc - 4;   // this warpgroup's boxes of output columns
  const long long bh = (long long)b * p.H + h;
  int qrow[2];
  float lse_r[2], dd_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qrow[i] = q0 + r0 + 8 * i;
    const bool real = qrow[i] < p.T;
    lse_r[i] = real ? p.lse[bh * p.T + qrow[i]] : 0.f;
    dd_r[i] = real ? p.dd[bh * p.T + qrow[i]] : 0.f;
  }
  float acc0[64], acc1[64];  // columns 256 wg + [0, 128) and + [128, 256)
#pragma unroll
  for (int j = 0; j < 64; ++j) acc0[j] = acc1[j] = 0.f;

  WPipe pipe;
  int used = 0;  // units consumed so far
  for (int kt = 0; kt < kt_end; ++kt) {
    if (first[kt] > limit) continue;
    const int k0 = kt * BK;

    // warpgroup 0: S = Q K^T; warpgroup 1: dP = dO V^T; over the chunks of d
    float x[32];
    for (int c = 0; c < nc; ++c) {
      if (threadIdx.x == 0) produce(used + WSTAGES);
      mbar_wait(ring.full(pipe.stage), pipe.phase);
      const uint32_t u = ring.unit(pipe.stage);
      __syncwarp();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(x, desc_sw128(u + wg * BOX + kk * 32), desc_sw128(u + (2 + wg) * BOX + kk * 32),
                 c > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(x);
      mbar_arrive(ring.empty(pipe.stage));
      pipe.advance();
      ++used;
    }

    // S to warpgroup 1, which turns it into dS (j = 4 n + 2 i + e is row
    // r0 + 8 i, column 8 n + c0 + e) and hands dS back as A fragments
    uint32_t a[4][4];
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < 32; ++j)
        asm volatile("st.shared.f32 [%0], %1;" ::"r"(sx + (j * NCONS + t) * 4), "f"(x[j])
                     : "memory");
    }
    bar_sync(1, DQ_SPLIT_NT);
    if (wg == 1) {
      unsigned vis = 0;  // this thread's 16 key columns: 8 n + c0 + e at bit 2 n + e
#pragma unroll
      for (int i = 0; i < 16; ++i)
        vis |= (unsigned)key_visible(p.mask, p.T, b, k0 + (i >> 1) * 8 + c0 + (i & 1)) << i;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        float s;
        asm volatile("ld.shared.f32 %0, [%1];" : "=f"(s) : "r"(sx + (j * NCONS + t) * 4)
                     : "memory");
        const int i = (j >> 1) & 1;
        const int col = (j >> 2) * 8 + c0 + (j & 1);
        const bool ok =
            ((vis >> (2 * (j >> 2) + (j & 1))) & 1u) && (!p.causal || k0 + col <= qrow[i]);
        const float pr = ok ? expf(s * p.scale - lse_r[i]) : 0.f;
        x[j] = pr * (x[j] - dd_r[i]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc_to_a(a[kk], x, kk);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          asm volatile("st.shared.u32 [%0], %1;" ::"r"(dsx + ((4 * kk + i) * NCONS + t) * 4),
                       "r"(a[kk][i])
                       : "memory");
      }
    }
    bar_sync(2, DQ_SPLIT_NT);
    if (wg == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[kk][i] = ld_shared_u32(dsx + ((4 * kk + i) * NCONS + t) * 4);
    }

    // dQ += round(dS) K over this warpgroup's columns (K read as stored):
    // the first output unit is warpgroup 0's, the second warpgroup 1's
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      if (threadIdx.x == 0) produce(used + WSTAGES);
      mbar_wait(ring.full(pipe.stage), pipe.phase);
      if (g == wg) {
        const uint32_t u = ring.unit(pipe.stage);
        fence_acc(acc0);
        fence_acc(acc1);
        __syncwarp();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs(acc0, a[kk], desc_sw128_mn(u + kk * 2048, BOX), 1);
          if (nbox > 2) wgmma_rs(acc1, a[kk], desc_sw128_mn(u + 2 * BOX + kk * 2048, BOX), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc0);
        fence_acc(acc1);
        fence_a(a);
      }
      mbar_arrive(ring.empty(pipe.stage));
      pipe.advance();
      ++used;
    }
  }

  bf16* dq = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qrow[i] < p.T) {
      const long long at = (bh * p.T + qrow[i]) * d;
#pragma unroll
      for (int n = 0; n < 32; ++n) {
        const int col = 256 * wg + n * 8 + c0;
        const float* acc = n < 16 ? acc0 : acc1;
        const int j = 4 * (n & 15) + 2 * i;
        if (col < d)
          *reinterpret_cast<uint32_t*>(&dq[at + col]) =
              pack_bf16(acc[j] * p.scale, acc[j + 1] * p.scale);
      }
    }
  }
}

// ------------- bf16 dK/dV, 256 < d <= CL_MAX_D: a cluster splits d -------------- //
//
// A kv tile is one cluster of c = ceil(d / 128) blocks. Block r owns
// columns [128 r, 128 r + 128) of d (the last one 64 when d is an odd
// multiple of 64), in the reduction and in the output alike, and runs the
// d = 128 kernel's loop on them: it loads its slices of K and V once (2 x 16
// KB) and streams its slices of Q and dO through a ring of two 32 KB stages,
// one whole 64-query tile a stage (its S^T and dP^T leave the registers
// before the output products' A operands come in, so dK and dV keep the 128
// accumulator registers they take at d = 128). Its S^T and dP^T over its
// columns are partial sums, which the cluster adds through distributed
// shared memory in two rounds per tile, each closed by an mbarrier in every
// block that its thread 0 arms with the round's byte count:
// 1. reduce-scatter: block r receives rows (keys) [64 r / c, 64 (r + 1) /
//    c) of every other block's f32 partials, one bulk copy (S^T rows, then
//    dP^T rows) from each, adds them in rank order 0 .. c - 1 (one block adds
//    each element, in one order: deterministic) and applies the softmax / dS
//    rule to them;
// 2. all-gather: it sends those rows of P^T and dS^T, rounded to bf16, to
//    every other block in one bulk copy each; every block then holds the A
//    operands of its own columns of dV += P^T dO and dK += dS^T Q.
// Per q tile a block reads 32 KB from L2 (its slices of Q and dO) against
// the column-group kernel's 576 KB (288 KB for each 32-query half), and
// moves (c - 1) / c x 32 KB of partials and (c - 1) / c x 17 KB of bf16 rows
// into (and out of) distributed shared memory: 36.75 KB each way at c = 4.
// Summing every partial in every block instead (one round) would move
// (c - 1) x 32 KB in (96 KB at c = 4) and need as much buffer. The copies
// are bulk copies (cp.async.bulk, shared::cta to shared::cluster) issued
// by one thread after the warpgroup's barrier: remote stores from every
// thread, remote loads of the partials, copies issued per warp and a
// second consumer warpgroup in ping-pong each ran slower on the H100. ~186
// KB of shared memory: one block an SM. Past CL_MAX_D (c > 8, the portable
// cluster limit) the column-group kernel above runs. dQ does not use
// these clusters: they ran dQ slower than the column-group kernel up to
// d = 896, as dQ's output work is half of dK/dV's (PERF.md).

constexpr int CL_MAX_D = 1024;
constexpr int SLICE = 2 * BOX;            // a block's [64, 128] slice of a tile: 16 KB
constexpr int XROW = 64 * 4;              // a row of a partial: 64 floats, unpadded
constexpr int XBYTES = 2 * 64 * XROW;     // S^T and dP^T to send, band by band (32 KB)
constexpr int RBYTES = 2 * 72 * XROW;     // a band's rows from every block: c ceil(64 / c) <= 70
constexpr int AP = 2 * 64 + 8;            // a row of P^T then dS^T, bf16: rows 4 banks apart
constexpr int ABYTES = 64 * AP * 2;       // the bf16 A operands (17 KB)

// Shared memory of a cluster block: resident slices res(0) = K, res(1) = V;
// STAGES stages of Q and dO slices; its partials to send (send: for each
// band j, its S^T rows then its dP^T rows, from row 2 band_lo(j)); the
// band's rows from every block (recv: slot k = block k's S^T rows then dP^T
// rows; its own slot written in place); the bf16 operands (a row: P^T, then
// dS^T); full / empty [STAGES], the resident slices' barrier, the two
// exchange barriers; the first visible key of each kv tile. A partial keeps
// row `row`'s column col at col ^ 8 (row & 3): the fragment stores meet no
// bank twice, and no row carries padding to send.
struct ClusterSmem {
  uint32_t base;
  int* first;
  __device__ __forceinline__ uint32_t res(int i) const { return base + i * SLICE; }
  __device__ __forceinline__ uint32_t stage(int s) const { return base + (2 + 2 * s) * SLICE; }
  __device__ __forceinline__ uint32_t send() const { return stage(STAGES); }
  __device__ __forceinline__ uint32_t recv() const { return send() + XBYTES; }
  __device__ __forceinline__ uint32_t ops() const { return recv() + RBYTES; }
  __device__ __forceinline__ uint32_t full(int s) const { return ops() + ABYTES + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return full(STAGES + s); }
  __device__ __forceinline__ uint32_t res_bar() const { return full(2 * STAGES); }
  __device__ __forceinline__ uint32_t part_bar() const { return full(2 * STAGES + 1); }
  __device__ __forceinline__ uint32_t op_bar() const { return full(2 * STAGES + 2); }
};

constexpr int cluster_smem_bytes(int nt) {
  return 1024 + (2 + 2 * STAGES) * SLICE + XBYTES + RBYTES + ABYTES + (2 * STAGES + 3) * 8 +
         4 * nt;
}

// Rows [band_lo(r, c), band_lo(r + 1, c)) of a 64-row tile: block r's band;
// band_of(row, c): the block whose band holds the row.
__device__ __forceinline__ int band_lo(int r, int c) { return 64 * r / c; }
__device__ __forceinline__ int band_of(int row, int c) { return ((row + 1) * c - 1) / 64; }

// The byte offset of (row, col) in a run of partial rows that starts at
// tile row `first` (the swizzle above).
__device__ __forceinline__ uint32_t xoff(int first, int row, int col) {
  return (row - first) * XROW + ((col ^ ((row & 3) << 3)) << 2);
}

// Aligns the shared memory, initialises the barriers, fills first[kt] for
// kt0 .. kt1 - 1 and syncs the cluster (every block's barriers exist before
// any copy reaches them).
__device__ __forceinline__ ClusterSmem cluster_setup(unsigned char* raw, const int* mask, int T,
                                                     int b, int kt0, int kt1) {
  const uint32_t base = (smem_u32(raw) + 1023u) & ~1023u;
  ClusterSmem sm{base, nullptr};
  sm.first = reinterpret_cast<int*>(raw + (sm.full(2 * STAGES + 3) - smem_u32(raw)));
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), NCONS);
    }
    mbar_init(sm.res_bar(), 1);
    mbar_init(sm.part_bar(), 1);  // thread 0's expect_tx, then the round's bytes
    mbar_init(sm.op_bar(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int kt = kt0 + (int)(threadIdx.x >> 5); kt < kt1; kt += WG_NT / 32)
    sm.first[kt] = first_visible_key(mask, T, b, kt * BK);
  cluster_sync();
  return sm;
}

// Producer: this block's nb boxes of the 64-row tile at row r0 of two maps
// into dst and dst + SLICE, completing on bar.
__device__ __forceinline__ void load_slices(uint32_t dst, const CUtensorMap* a,
                                            const CUtensorMap* b_, uint32_t bar, int col0,
                                            int nb, int r0, int h, int b) {
  mbar_expect_tx(bar, 2 * nb * BOX);
  for (int i = 0; i < nb; ++i) {
    tma_load_4d(dst + i * BOX, a, bar, col0 + 64 * i, r0, h, b);
    tma_load_4d(dst + SLICE + i * BOX, b_, bar, col0 + 64 * i, r0, h, b);
  }
}

// Consumer: the partial S^T = K Q^T and dP^T = V dO^T over this block's
// columns (nb boxes: 4 k16 steps each), Q at qs and dO at qs + SLICE.
__device__ __forceinline__ void partial_products(const ClusterSmem& sm, uint32_t qs, int nb,
                                                 float (&s)[32], float (&dp)[32]) {
  __syncwarp();
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (kk < 4 * nb) {
      const uint32_t off = kmajor_step(kk);
      wgmma_ss(s, desc_sw128(sm.res(0) + off), desc_sw128(qs + off), kk > 0);
      wgmma_ss(dp, desc_sw128(sm.res(1) + off), desc_sw128(qs + SLICE + off), kk > 0);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(s);
  fence_acc(dp);
}

// Consumer: this thread's fragments of the partials, its band's rows into
// its own recv slot r and the others into send; then thread 0 arms its
// part_bar for the c - 1 slots it receives and sends each other block j the
// rows of j's band (S^T and dP^T: one copy) into slot r of j's recv. Every
// block sends before it waits, so the copies of a tile meet barriers whose
// previous phase is over.
__device__ __forceinline__ void send_partials(const ClusterSmem& sm, const float (&s)[32],
                                              const float (&dp)[32], int c, int r) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2), c0 = (lane & 3) * 2;
  const uint32_t slot = 2 * ((64 + c - 1) / c) * XROW;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i, j = band_of(row, c);
    const int lo = band_lo(j, c), n = band_lo(j + 1, c) - lo;
    const uint32_t at = j == r ? sm.recv() + r * slot : sm.send() + 2 * lo * XROW;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const uint32_t off = xoff(lo, row, 8 * m + c0);
      st_shared_f2(at + off, s[4 * m + 2 * i], s[4 * m + 2 * i + 1]);
      st_shared_f2(at + n * XROW + off, dp[4 * m + 2 * i], dp[4 * m + 2 * i + 1]);
    }
  }
  fence_proxy_async();
  consumers_sync();
  if (threadIdx.x == 0) {
    mbar_expect_tx(sm.part_bar(), (c - 1) * 2 * (band_lo(r + 1, c) - band_lo(r, c)) * XROW);
    for (int j = 0; j < c; ++j) {
      if (j == r) continue;
      const int lo = band_lo(j, c);
      bulk_to_cluster(cluster_map(sm.recv() + r * slot, j), sm.send() + 2 * lo * XROW,
                      2 * (band_lo(j + 1, c) - lo) * XROW, cluster_map(sm.part_bar(), j));
    }
  }
}

// Consumer: the cluster's S^T and dP^T at tile row `row` of this block's
// band (lo, n rows), columns col .. col + 3: the c slots added in rank order.
__device__ __forceinline__ void summed(const ClusterSmem& sm, int c, int lo, int n, int row,
                                       int col, float (&s)[4], float (&dp)[4]) {
  const uint32_t slot = 2 * ((64 + c - 1) / c) * XROW;
  const uint32_t at = sm.recv() + xoff(lo, row, col);
  float4 a = ld_shared_f4(at);
  float4 g = ld_shared_f4(at + n * XROW);
  for (int k = 1; k < c; ++k) {
    const float4 x = ld_shared_f4(at + k * slot);
    const float4 y = ld_shared_f4(at + k * slot + n * XROW);
    a.x += x.x, a.y += x.y, a.z += x.z, a.w += x.w;
    g.x += y.x, g.y += y.y, g.z += y.z, g.w += y.w;
  }
  s[0] = a.x, s[1] = a.y, s[2] = a.z, s[3] = a.w;
  dp[0] = g.x, dp[1] = g.y, dp[2] = g.z, dp[3] = g.w;
}

// Consumer: x rounded to bf16 at (row, col .. col + 3) of this block's
// operand i (0: P^T, 1: dS^T).
__device__ __forceinline__ void put_bf16(const ClusterSmem& sm, int i, int row, int col,
                                         const float (&x)[4]) {
  st_shared_u2(sm.ops() + (row * AP + 64 * i + col) * 2, pack_bf16(x[0], x[1]),
               pack_bf16(x[2], x[3]));
}

// Consumer: thread 0 arms its op_bar for the other bands' rows and sends
// this block's band of the bf16 operands to every other block (one copy
// each); then every thread waits for the other bands.
__device__ __forceinline__ void gathered(const ClusterSmem& sm, int c, int r, uint32_t ph) {
  fence_proxy_async();
  consumers_sync();
  if (threadIdx.x == 0) {
    const int lo = band_lo(r, c), n = band_lo(r + 1, c) - lo;
    mbar_expect_tx(sm.op_bar(), (64 - n) * AP * 2);
    for (int j = 0; j < c; ++j)
      if (j != r)
        bulk_to_cluster(cluster_map(sm.ops() + lo * AP * 2, j), sm.ops() + lo * AP * 2,
                        n * AP * 2, cluster_map(sm.op_bar(), j));
  }
  mbar_wait(sm.op_bar(), ph);
}

// Consumer: the four k16 A fragments of operand i, in acc_to_a's layout.
__device__ __forceinline__ void load_a(const ClusterSmem& sm, int i, uint32_t (&a)[4][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2), c0 = (lane & 3) * 2;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t at = sm.ops() + (r0 * AP + 64 * i + 16 * kk + c0) * 2;
    a[kk][0] = ld_shared_u32(at);
    a[kk][1] = ld_shared_u32(at + 8 * AP * 2);
    a[kk][2] = ld_shared_u32(at + 16);
    a[kk][3] = ld_shared_u32(at + 8 * AP * 2 + 16);
  }
}

// bf16 dK/dV: a cluster per (kv tile, b, kv head), walking the q tiles of
// each query head of its GQA group; a thread's rows (keys) of the band are
// brow0 + 8 ps (ps < 3: a band holds at most 22 rows, c >= 3).
__global__ void __launch_bounds__(WG_NT, 1)
    flash_dkv_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap to, const Params p, int d) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int c = (d + 127) / 128;
  const int r = cluster_rank();
  const int nb = min(2, d / 64 - 2 * r);
  const int col0 = 128 * r;
  const int nt = (p.T + BK - 1) / BK;
  const int blk = blockIdx.x / c;
  const int kt = blk / (p.B * p.Hkv);
  const int b = blk / p.Hkv % p.B;
  const int hk = blk % p.Hkv;
  const int k0 = kt * BK;
  const int rep = p.H / p.Hkv;
  const long long bk = (long long)b * p.Hkv + hk;
  const ClusterSmem sm = cluster_setup(smem_raw, p.mask, p.T, b, kt, kt + 1);
  const int f = sm.first[kt];

  if (f >= p.T) {  // no visible key in this kv tile: dK = dV = 0 (the whole cluster)
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    const int rows = min(BK, p.T - k0), cols = nb * 64;
    for (int e = threadIdx.x; e < rows * (cols / 8); e += WG_NT) {
      const long long at = (bk * p.T + k0 + e / (cols / 8)) * d + col0 + (e % (cols / 8)) * 8;
      *reinterpret_cast<uint4*>(static_cast<bf16*>(p.dk) + at) = zero;
      *reinterpret_cast<uint4*>(static_cast<bf16*>(p.dv) + at) = zero;
    }
    return;
  }
  const int qt0 = p.causal ? f / BQ : 0;

  if (threadIdx.x >= NCONS) {  // producer warp: one thread issues every load
    if (threadIdx.x == NCONS) {
      load_slices(sm.res(0), &tk, &tv, sm.res_bar(), col0, nb, k0, hk, b);
      Pipe pipe;
      for (int h = hk * rep; h < (hk + 1) * rep; ++h) {
        for (int qt = qt0; qt < nt; ++qt) {
          mbar_wait(sm.empty(pipe.stage), pipe.phase ^ 1u);
          load_slices(sm.stage(pipe.stage), &tq, &to, sm.full(pipe.stage), col0, nb, qt * BQ, h,
                      b);
          pipe.advance();
        }
      }
    }
  } else {
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int r0 = warp * 16 + (lane >> 2), c0 = (lane & 3) * 2;
    const int lo = band_lo(r, c), hi = band_lo(r + 1, c);
    const int brow0 = lo + (tid >> 4), bcol = (tid & 15) * 4;
    int kvis[3];
#pragma unroll
    for (int ps = 0; ps < 3; ++ps) kvis[ps] = key_visible(p.mask, p.T, b, k0 + brow0 + 8 * ps);
    float dk[64], dv[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) dk[j] = dv[j] = 0.f;

    mbar_wait(sm.res_bar(), 0);
    Pipe pipe;
    uint32_t ph = 0;
    for (int h = hk * rep; h < (hk + 1) * rep; ++h) {
      const float* lse = p.lse + ((long long)b * p.H + h) * p.T;
      const float* ddh = p.dd + ((long long)b * p.H + h) * p.T;
      for (int qt = qt0; qt < nt; ++qt) {
        const int q0 = qt * BQ;
        mbar_wait(sm.full(pipe.stage), pipe.phase);
        const uint32_t qs = sm.stage(pipe.stage), os = qs + SLICE;
        {
          float s[32], dp[32];
          partial_products(sm, qs, nb, s, dp);
          send_partials(sm, s, dp, c, r);
        }
        float lq[4], dq4[4];  // this thread's queries q0 + bcol + e
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = q0 + bcol + e;
          lq[e] = q < p.T ? lse[q] : 0.f;
          dq4[e] = q < p.T ? ddh[q] : 0.f;
        }
        mbar_wait(sm.part_bar(), ph);
#pragma unroll
        for (int ps = 0; ps < 3; ++ps) {
          const int row = brow0 + 8 * ps;
          if (row < hi) {
            float s[4], dp[4];
            summed(sm, c, lo, hi - lo, row, bcol, s, dp);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int q = q0 + bcol + e;
              const bool ok = kvis[ps] && q < p.T && (!p.causal || k0 + row <= q);
              const float pr = ok ? expf(s[e] * p.scale - lq[e]) : 0.f;
              s[e] = pr;
              dp[e] = pr * (dp[e] - dq4[e]);
            }
            put_bf16(sm, 0, row, bcol, s);
            put_bf16(sm, 1, row, bcol, dp);
          }
        }
        gathered(sm, c, r, ph);
        ph ^= 1u;

        // dV += round(P^T) dO and dK += round(dS^T) Q over this block's
        // columns (dO and Q read as stored)
        uint32_t pa[4][4], da[4][4];
        load_a(sm, 0, pa);
        load_a(sm, 1, da);
        fence_acc(dv);
        fence_acc(dk);
        __syncwarp();
        wgmma_fence();
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
          wgmma_rs(dv, pa[kq], desc_sw128_mn(os + kq * 2048, BOX), 1);
          wgmma_rs(dk, da[kq], desc_sw128_mn(qs + kq * 2048, BOX), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(dv);
        fence_acc(dk);
        fence_a(pa);
        fence_a(da);
        mbar_arrive(sm.empty(pipe.stage));
        pipe.advance();
      }
    }

    bf16* dkg = static_cast<bf16*>(p.dk);
    bf16* dvg = static_cast<bf16*>(p.dv);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = k0 + r0 + 8 * i;
      if (key < p.T) {
        const long long at = (bk * p.T + key) * d;
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          const int col = col0 + n * 8 + c0;
          if (col < d) {
            const int j = 4 * n + 2 * i;
            *reinterpret_cast<uint32_t*>(&dkg[at + col]) =
                pack_bf16(dk[j] * p.scale, dk[j + 1] * p.scale);
            *reinterpret_cast<uint32_t*>(&dvg[at + col]) = pack_bf16(dv[j], dv[j + 1]);
          }
        }
      }
    }
  }
  cluster_sync();  // no block leaves while another may still reach its shared memory
}

// f32: FMAs as the built head dims' kernels, R = 64 rows a tile; the
// score-sized products over 64-column chunks staged transposed ([C][R + 1]),
// the output products' B operands over the group's columns ([OD][R + 1]).
constexpr int WIDE_C = 64;

// rows [r0, r0 + R) x columns [c0, c0 + C) of a [T, d] slice (row stride
// st) into dst[C][R + 1], transposed; rows at or past T and columns at or
// past d read as 0
template <int R, int C>
__device__ __forceinline__ void load_cols_t(float* dst, const float* src, long long st, int r0,
                                            int seq, int c0, int d) {
  constexpr int LD = R + 1;
  for (int e = threadIdx.x; e < R * C; e += NT) {
    const int r = e / C, c = e - (e / C) * C;
    const int row = r0 + r, col = c0 + c;
    dst[c * LD + r] = row < seq && col < d ? src[row * st + col] : 0.f;
  }
}

constexpr int dq_wide_smem_bytes() {
  // Qc, dOc, Kc, Vc [C][LD]; Ks [OD][LD]; dS [R][LD]; lse, D, visibility [R]
  constexpr int R = 64, LD = R + 1;
  return (4 * WIDE_C * LD + WIDE_OD * LD + R * LD + 2 * R) * 4 + R * 4;
}

constexpr int dkv_wide_smem_bytes() {
  // Kc, Vc, Qc, dOc [C][LD]; Qs, dOs [OD][LD]; P^T, dS^T [R][LD]; lse, D,
  // visibility [R]
  constexpr int R = 64, LD = R + 1;
  return (4 * WIDE_C * LD + 2 * WIDE_OD * LD + 2 * R * LD + 2 * R) * 4 + R * 4;
}

__global__ void __launch_bounds__(NT) flash_dq_f32_wide_kernel(const Params p, int d) {
  constexpr int R = 64, LD = R + 1, C = WIDE_C, OD = WIDE_OD;
  constexpr int RI = R / 16, CJ = R / 16, OJ = OD / 16;
  extern __shared__ float smem[];
  float* Qc = smem;
  float* Oc = Qc + C * LD;
  float* Kc = Oc + C * LD;
  float* Vc = Kc + C * LD;
  float* Ks = Vc + C * LD;  // [OD][LD]: the group's columns of K, transposed
  float* Ss = Ks + OD * LD;
  float* row_lse = Ss + R * LD;
  float* row_dd = row_lse + R;
  int* pm = reinterpret_cast<int*>(row_dd + R);

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int ng = (d + OD - 1) / OD;
  const int cg = blockIdx.x % ng;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = (blockIdx.x / ng) * R;
  const int seq = p.T;

  const float* qg = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
  const float* og = static_cast<const float*>(p.dout) + b * p.sob + h * p.soh;
  const float* kg = static_cast<const float*>(p.k) + b * p.skb + hk * p.skh;
  const float* vg = static_cast<const float*>(p.v) + b * p.svb + hk * p.svh;
  if (tid < R) {
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

  const int kv_end = p.causal ? min(seq, q0 + R) : seq;
  for (int k0 = 0; k0 < kv_end; k0 += R) {
    float s[RI][CJ], dp[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int cc = 0; cc < d; cc += C) {
      __syncthreads();  // the previous chunk's (or tile's) readers are done
      load_cols_t<R, C>(Qc, qg, p.sqt, q0, seq, cc, d);
      load_cols_t<R, C>(Oc, og, p.sot, q0, seq, cc, d);
      load_cols_t<R, C>(Kc, kg, p.skt, k0, seq, cc, d);
      load_cols_t<R, C>(Vc, vg, p.svt, k0, seq, cc, d);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < C; ++kk) {
        float qv[RI], ov[RI], kv[CJ], vv[CJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          qv[i] = Qc[kk * LD + ty + 16 * i];
          ov[i] = Oc[kk * LD + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          kv[j] = Kc[kk * LD + tx + 16 * j];
          vv[j] = Vc[kk * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
          }
      }
    }
    load_cols_t<R, OD>(Ks, kg, p.skt, k0, seq, cg * OD, d);
    if (tid < R) pm[tid] = key_visible(p.mask, p.T, b, k0 + tid);
    __syncthreads();

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

#pragma unroll 4
    for (int kk = 0; kk < R; ++kk) {
      float sv[RI], kv[OJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) sv[i] = Ss[(ty + 16 * i) * LD + kk];
#pragma unroll
      for (int j = 0; j < OJ; ++j) kv[j] = Ks[(tx + 16 * j) * LD + kk];
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
      const long long base = ((long long)bh * seq + row) * d;
#pragma unroll
      for (int j = 0; j < OJ; ++j) {
        const int col = cg * OD + tx + 16 * j;
        if (col < d) dq[base + col] = acc[i][j] * p.scale;
      }
    }
  }
}

__global__ void __launch_bounds__(NT) flash_dkv_f32_wide_kernel(const Params p, int d) {
  constexpr int R = 64, LD = R + 1, C = WIDE_C, OD = WIDE_OD;
  constexpr int RI = R / 16, CJ = R / 16, OJ = OD / 16;
  extern __shared__ float smem[];
  float* Kc = smem;
  float* Vc = Kc + C * LD;
  float* Qc = Vc + C * LD;
  float* Oc = Qc + C * LD;
  float* Qs = Oc + C * LD;  // [OD][LD]: the group's columns of Q, transposed
  float* Os = Qs + OD * LD;  // and of dO
  float* Ps = Os + OD * LD;  // P^T  [key][query]
  float* Ss = Ps + R * LD;   // dS^T [key][query]
  float* row_lse = Ss + R * LD;
  float* row_dd = row_lse + R;
  int* pm = reinterpret_cast<int*>(row_dd + R);

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int ng = (d + OD - 1) / OD;
  const int cg = blockIdx.x % ng;
  const int bk = blockIdx.y;
  const int b = bk / p.Hkv;
  const int hk = bk - b * p.Hkv;
  const int rep = p.H / p.Hkv;
  const int k0 = (blockIdx.x / ng) * R;
  const int seq = p.T;

  const float* kg = static_cast<const float*>(p.k) + b * p.skb + hk * p.skh;
  const float* vg = static_cast<const float*>(p.v) + b * p.svb + hk * p.svh;
  if (tid < R) pm[tid] = key_visible(p.mask, p.T, b, k0 + tid);

  float dk[RI][OJ], dv[RI][OJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int q_start = p.causal ? (k0 / R) * R : 0;
  for (int h = hk * rep; h < (hk + 1) * rep; ++h) {
    const int bh = b * p.H + h;
    const float* qg = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
    const float* og = static_cast<const float*>(p.dout) + b * p.sob + h * p.soh;
    for (int q0 = q_start; q0 < seq; q0 += R) {
      float s[RI][CJ], dp[RI][CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int cc = 0; cc < d; cc += C) {
        __syncthreads();  // the previous chunk's (or tile's) readers are done
        load_cols_t<R, C>(Kc, kg, p.skt, k0, seq, cc, d);
        load_cols_t<R, C>(Vc, vg, p.svt, k0, seq, cc, d);
        load_cols_t<R, C>(Qc, qg, p.sqt, q0, seq, cc, d);
        load_cols_t<R, C>(Oc, og, p.sot, q0, seq, cc, d);
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < C; ++kk) {
          float kv[RI], vv[RI], qv[CJ], ov[CJ];
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            kv[i] = Kc[kk * LD + ty + 16 * i];
            vv[i] = Vc[kk * LD + ty + 16 * i];
          }
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            qv[j] = Qc[kk * LD + tx + 16 * j];
            ov[j] = Oc[kk * LD + tx + 16 * j];
          }
#pragma unroll
          for (int i = 0; i < RI; ++i)
#pragma unroll
            for (int j = 0; j < CJ; ++j) {
              s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
              dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
            }
        }
      }
      load_cols_t<R, OD>(Qs, qg, p.sqt, q0, seq, cg * OD, d);
      load_cols_t<R, OD>(Os, og, p.sot, q0, seq, cg * OD, d);
      if (tid < R) {
        const int row = q0 + tid;
        const long long at = (long long)bh * seq + row;
        row_lse[tid] = row < seq ? p.lse[at] : 0.f;
        row_dd[tid] = row < seq ? p.dd[at] : 0.f;
      }
      __syncthreads();

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

#pragma unroll 4
      for (int kk = 0; kk < R; ++kk) {
        float pv[RI], sv[RI], ov[OJ], qv[OJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          pv[i] = Ps[(ty + 16 * i) * LD + kk];
          sv[i] = Ss[(ty + 16 * i) * LD + kk];
        }
#pragma unroll
        for (int j = 0; j < OJ; ++j) {
          ov[j] = Os[(tx + 16 * j) * LD + kk];
          qv[j] = Qs[(tx + 16 * j) * LD + kk];
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
      const long long base = ((long long)bk * seq + key) * d;
#pragma unroll
      for (int j = 0; j < OJ; ++j) {
        const int col = cg * OD + tx + 16 * j;
        if (col < d) {
          dkg[base + col] = dk[i][j] * p.scale;
          dvg[base + col] = dv[i][j];
        }
      }
    }
  }
}

// What the last launch of this library ran, as its launcher configured it:
// the kind of kernel, the blocks in a cluster (1: no cluster) and the
// threads a block. flash_attention_dq / _dkv copy it to their own record
// once the launch is accepted; flash_attention_bwd_last_launch reads that
// record back.
struct Launch {
  const char* kind;
  int cluster, threads;
};
Launch g_launch = {"none", 0, 0};
Launch g_last[2] = {{"none", 0, 0}, {"none", 0, 0}};  // dQ, dK/dV

cudaError_t recorded(cudaError_t err, const char* kind, int cluster, int threads) {
  if (err == cudaSuccess) g_launch = Launch{kind, cluster, threads};
  return err;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, int bytes, dim3 grid, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, stream>>>(p);
  return recorded(cudaGetLastError(), "f32", 1, threads);
}

// The bf16 kernels: tensor maps of q, k, v and dO, then one block per
// (tile, b, head).
template <int HD, typename Kernel>
cudaError_t launch_wgmma(Kernel kernel, int heads, const Params& p, cudaStream_t stream) {
  const int d = HD;
  const int nt = (p.T + BK - 1) / BK;
  const int bytes = wgmma_smem_bytes<HD, 2>(nt);
  CUtensorMap tq, tk, tv, to;
  int err = make_map_bf16_4d(&tq, p.q, p.B, p.H, p.T, d, p.sqb, p.sqh, p.sqt, BQ);
  if (!err) err = make_map_bf16_4d(&tk, p.k, p.B, p.Hkv, p.T, d, p.skb, p.skh, p.skt, BK);
  if (!err) err = make_map_bf16_4d(&tv, p.v, p.B, p.Hkv, p.T, d, p.svb, p.svh, p.svt, BK);
  if (!err) err = make_map_bf16_4d(&to, p.dout, p.B, p.H, p.T, d, p.sob, p.soh, p.sot, BQ);
  if (err) return static_cast<cudaError_t>(err);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)p.B * nt * heads * (HD / out_cols<HD>());
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, WG_NT, bytes, stream>>>(tq, tk, tv, to, p);
  return recorded(cudaGetLastError(), "wgmma", 1, WG_NT);
}

// The wide kernels (d > 256, a multiple of 64): bf16 through tensor maps of
// q, k, v and dO, one block per (column group, tile, b, head); f32 on a grid
// of (tiles x column groups, b x heads).
template <typename Wide, typename WideF32>
cudaError_t launch_wide(Wide kernel, WideF32 kernel_f32, int f32_bytes, int heads,
                        const Params& p, int d, int is_bf16, cudaStream_t stream) {
  const int nt = (p.T + BK - 1) / BK;
  const int ng = (d + WIDE_OD - 1) / WIDE_OD;
  if (!is_bf16) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, f32_bytes);
    if (e != cudaSuccess) return e;
    kernel_f32<<<dim3(nt * ng, p.B * heads), NT, f32_bytes, stream>>>(p, d);
    return recorded(cudaGetLastError(), "column_groups_f32", 1, NT);
  }
  const int bytes = wide_smem_bytes(nt);
  CUtensorMap tq, tk, tv, to;
  int err = make_map_bf16_4d(&tq, p.q, p.B, p.H, p.T, d, p.sqb, p.sqh, p.sqt, BQ);
  if (!err) err = make_map_bf16_4d(&tk, p.k, p.B, p.Hkv, p.T, d, p.skb, p.skh, p.skt, BK);
  if (!err) err = make_map_bf16_4d(&tv, p.v, p.B, p.Hkv, p.T, d, p.svb, p.svh, p.svt, BK);
  if (!err) err = make_map_bf16_4d(&to, p.dout, p.B, p.H, p.T, d, p.sob, p.soh, p.sot, BQ);
  if (err) return static_cast<cudaError_t>(err);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)p.B * nt * heads * ng;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, WG_NT, bytes, stream>>>(tq, tk, tv, to, p, d);
  return recorded(cudaGetLastError(), "column_groups", 1, WG_NT);
}

// The bf16 dQ for 256 < d <= DQ_SPLIT_MAX_D (a multiple of 64): one block of
// two warpgroups per (q tile, b, head).
cudaError_t launch_dq_split(const Params& p, int d, cudaStream_t stream) {
  const int nt = (p.T + BK - 1) / BK;
  const int bytes = dq_split_smem_bytes(nt);
  CUtensorMap tq, tk, tv, to;
  int err = make_map_bf16_4d(&tq, p.q, p.B, p.H, p.T, d, p.sqb, p.sqh, p.sqt, BQ);
  if (!err) err = make_map_bf16_4d(&tk, p.k, p.B, p.Hkv, p.T, d, p.skb, p.skh, p.skt, BK);
  if (!err) err = make_map_bf16_4d(&tv, p.v, p.B, p.Hkv, p.T, d, p.svb, p.svh, p.svt, BK);
  if (!err) err = make_map_bf16_4d(&to, p.dout, p.B, p.H, p.T, d, p.sob, p.soh, p.sot, BQ);
  if (err) return static_cast<cudaError_t>(err);
  cudaError_t e = cudaFuncSetAttribute(flash_dq_split_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)p.B * nt * p.H;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  flash_dq_split_kernel<<<(unsigned)blocks, DQ_SPLIT_NT, bytes, stream>>>(tq, tk, tv, to, p, d);
  return recorded(cudaGetLastError(), "dq_split", 1, DQ_SPLIT_NT);
}

// The bf16 dK/dV clusters (256 < d <= CL_MAX_D, a multiple of 64): one
// cluster of ceil(d / 128) blocks per (kv tile, b, kv head).
cudaError_t launch_dkv_cluster(const Params& p, int d, cudaStream_t stream) {
  const int nt = (p.T + BK - 1) / BK;
  const int c = (d + 127) / 128;
  const int bytes = cluster_smem_bytes(nt);
  CUtensorMap tq, tk, tv, to;
  int err = make_map_bf16_4d(&tq, p.q, p.B, p.H, p.T, d, p.sqb, p.sqh, p.sqt, BQ);
  if (!err) err = make_map_bf16_4d(&tk, p.k, p.B, p.Hkv, p.T, d, p.skb, p.skh, p.skt, BK);
  if (!err) err = make_map_bf16_4d(&tv, p.v, p.B, p.Hkv, p.T, d, p.svb, p.svh, p.svt, BK);
  if (!err) err = make_map_bf16_4d(&to, p.dout, p.B, p.H, p.T, d, p.sob, p.soh, p.sot, BQ);
  if (err) return static_cast<cudaError_t>(err);
  cudaError_t e = cudaFuncSetAttribute(flash_dkv_cluster_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)p.B * nt * p.Hkv * c;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(WG_NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, flash_dkv_cluster_kernel, tq, tk, tv, to, p, d);
  return recorded(e != cudaSuccess ? e : cudaGetLastError(), "dkv_cluster",
                  (int)attr[0].val.clusterDim.x, (int)cfg.blockDim.x);
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

static int dispatch_dq(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* dd, const int* mask, void* dq, int B,
                       int H, int Hkv, int T, int d, const long long* strides, int causal,
                       int is_bf16, float scale, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, dd, mask, dq, nullptr, nullptr, B, H, Hkv, T,
                               strides, causal, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d > 256 && d % 64 == 0) {
    if (is_bf16 && d <= DQ_SPLIT_MAX_D) return launch_dq_split(p, d, st);
    return launch_wide(flash_dq_wide_kernel, flash_dq_f32_wide_kernel, dq_wide_smem_bytes(), H,
                       p, d, is_bf16, st);
  }
  if (is_bf16) {
    if (d == 128) return launch_wgmma<128>(flash_dq_wgmma_kernel<128>, H, p, st);
    if (d == 64) return launch_wgmma<64>(flash_dq_wgmma_kernel<64>, H, p, st);
    if (d == 256) return launch_wgmma<256>(flash_dq_wgmma_kernel<256>, H, p, st);
  } else {
    const dim3 grid((T + f32_rows<128>() - 1) / f32_rows<128>(), B * H);
    const dim3 grid256((T + f32_rows<256>() - 1) / f32_rows<256>(), B * H);
    if (d == 128) return launch(flash_dq_f32_kernel<128>, NT, dq_smem_bytes<128>(), grid, p, st);
    if (d == 64) return launch(flash_dq_f32_kernel<64>, NT, dq_smem_bytes<64>(), grid, p, st);
    if (d == 256)
      return launch(flash_dq_f32_kernel<256>, NT, dq_smem_bytes<256>(), grid256, p, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

static int dispatch_dkv(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* dd, const int* mask, void* dk, void* dv,
                        int B, int H, int Hkv, int T, int d, const long long* strides,
                        int causal, int is_bf16, float scale, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, dd, mask, nullptr, dk, dv, B, H, Hkv, T,
                               strides, causal, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d > 256 && d % 64 == 0) {
    if (is_bf16 && d <= CL_MAX_D) return launch_dkv_cluster(p, d, st);
    return launch_wide(flash_dkv_wide_kernel, flash_dkv_f32_wide_kernel, dkv_wide_smem_bytes(),
                       Hkv, p, d, is_bf16, st);
  }
  if (is_bf16) {
    if (d == 128) return launch_wgmma<128>(flash_dkv_wgmma_kernel<128>, Hkv, p, st);
    if (d == 64) return launch_wgmma<64>(flash_dkv_wgmma_kernel<64>, Hkv, p, st);
    if (d == 256) return launch_wgmma<256>(flash_dkv_wgmma_kernel<256>, Hkv, p, st);
  } else {
    const dim3 grid((T + f32_rows<128>() - 1) / f32_rows<128>(), B * Hkv);
    const dim3 grid256((T + f32_rows<256>() - 1) / f32_rows<256>(), B * Hkv);
    if (d == 128)
      return launch(flash_dkv_f32_kernel<128>, NT, dkv_smem_bytes<128>(), grid, p, st);
    if (d == 64) return launch(flash_dkv_f32_kernel<64>, NT, dkv_smem_bytes<64>(), grid, p, st);
    if (d == 256)
      return launch(flash_dkv_f32_kernel<256>, NT, dkv_smem_bytes<256>(), grid256, p, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// strides: 12 values, (b, h, t) strides of q, k, v and dout in that order.
// Each returns a cudaError_t: 0 when the launch was accepted.
extern "C" int flash_attention_dq(const void* q, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* dd, const int* mask, void* dq,
                                  int B, int H, int Hkv, int T, int d, const long long* strides,
                                  int causal, int is_bf16, float scale, void* stream) {
  const int err = dispatch_dq(q, k, v, dout, lse, dd, mask, dq, B, H, Hkv, T, d, strides, causal,
                              is_bf16, scale, stream);
  if (err == 0) g_last[0] = g_launch;
  return err;
}

extern "C" int flash_attention_dkv(const void* q, const void* k, const void* v, const void* dout,
                                   const float* lse, const float* dd, const int* mask, void* dk,
                                   void* dv, int B, int H, int Hkv, int T, int d,
                                   const long long* strides, int causal, int is_bf16, float scale,
                                   void* stream) {
  const int err = dispatch_dkv(q, k, v, dout, lse, dd, mask, dk, dv, B, H, Hkv, T, d, strides,
                               causal, is_bf16, scale, stream);
  if (err == 0) g_last[1] = g_launch;
  return err;
}

// The last accepted launch of flash_attention_dq (dkv = 0) or
// flash_attention_dkv (dkv = 1) in this process, as its launcher configured
// it: the kind of kernel ("wgmma", "f32", "column_groups",
// "column_groups_f32", "dq_split", "dkv_cluster"; "none" before the first),
// the blocks in a cluster (1: no cluster) and the threads a block.
extern "C" int flash_attention_bwd_last_launch(int dkv, const char** kind, int* cluster,
                                               int* threads) {
  if (dkv != 0 && dkv != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Launch& l = g_last[dkv];
  *kind = l.kind;
  *cluster = l.cluster;
  *threads = l.threads;
  return 0;
}
