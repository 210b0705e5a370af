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
// Past 256 (any multiple of 64, no upper limit) the wide kernels extend that
// mechanism: ceil(d / 128) column-group blocks a tile, each recomputing S
// and dP over 64-column chunks of its operands streamed through a ring of
// 32 KB units (the tiles of d = 256's kernels no longer fit beside the
// ring), then taking the group's columns of the output products' B
// operands as a unit of their own. dK/dV runs each q tile's two 32-query
// halves as two passes over the chunks (the registers of both halves' S
// and dP beside dK and dV would not fit).
//
// What bounds it on the H100. At the GRPO learn shapes ([16, 32/8, 320, 128]
// bf16) the bytes (q, k, v, dO, lse, D read once; dQ or dK/dV written once)
// take 0.04 ms, the work (6 or 8 flops per visible (q, k) pair and head
// dimension) 0.01-0.02 ms on bf16 tensor cores: memory-bound by the card's
// measure. The bf16 kernels' own limits are the short loops at small T (a
// tile meets at most T / 64 others, so the ring barely fills), the
// serialisation of each tile's two products, and L2 re-reads of the streamed
// tiles by every block that needs them. PERF.md holds their times beside the
// bound.

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
// the output products' B operands come as a unit of their own.

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

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, int bytes, dim3 grid, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, stream>>>(p);
  return cudaGetLastError();
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
  return cudaGetLastError();
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
    return cudaGetLastError();
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
  if (d > 256 && d % 64 == 0)
    return launch_wide(flash_dq_wide_kernel, flash_dq_f32_wide_kernel, dq_wide_smem_bytes(), H,
                       p, d, is_bf16, st);
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

extern "C" int flash_attention_dkv(const void* q, const void* k, const void* v, const void* dout,
                                   const float* lse, const float* dd, const int* mask, void* dk,
                                   void* dv, int B, int H, int Hkv, int T, int d,
                                   const long long* strides, int causal, int is_bf16, float scale,
                                   void* stream) {
  const Params p = make_params(q, k, v, dout, lse, dd, mask, nullptr, dk, dv, B, H, Hkv, T,
                               strides, causal, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d > 256 && d % 64 == 0)
    return launch_wide(flash_dkv_wide_kernel, flash_dkv_f32_wide_kernel, dkv_wide_smem_bytes(),
                       Hkv, p, d, is_bf16, st);
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
