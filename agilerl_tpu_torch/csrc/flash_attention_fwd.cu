// Flash attention forward (out and logsumexp) for Hopper, sm_90a.
//
// Replaces the TPU kernel agilerl_tpu/ops/flash_attention_vjp.py:_fwd_kernel
// (pallas_call in _fwd), which also serves agilerl_tpu/ops/flash_attention.py
// (the same forward with the logsumexp discarded).
//
// What it computes, per (batch b, head h, query row q):
//   s_k   = (q . k_k) * scale, masked to -1e30 unless k < T, (causal) k <= q
//           and padding_mask[b, k] > 0
//   out_q = sum_k softmax(s)_k v_k      lse_q = m + log(max(l, 1e-30))
// with the TPU kernel's online softmax: f32 (m, l, acc), p rounded to the
// input type before the P.V product, out = acc / max(l, 1e-30).
//
// Translation. The TPU grid (b*h, q block, kv block) runs the kv axis in order
// and carries (m, l, acc) in VMEM scratch from one grid step to the next.
// Here one thread block owns one (b, head, 64-row q tile) and walks the kv
// tiles in a loop; (m, l, acc) stay in registers. GQA: the block reads KV
// head h / (H / Hkv) in place, so the caller need not repeat K/V (a repeated
// copy, Hkv == H, works too).
//
// Two kernels, chosen by the input type:
// - bf16 (the model's path): wgmma fed by TMA, built from the pieces of the
//   flash backward (csrc/flash_wgmma.cuh). A block is one consumer warpgroup
//   (64 query rows) and one producer warp, two blocks an SM. The producer
//   loads the Q tile once and streams each kv tile's K and V through a ring
//   of two stages, K and V each on its own full/empty mbarriers, so that K
//   is freed once S is done and V once P V is. q, k and v are read as 4-D
//   tensor maps (d, T, heads, B) over the callers' strided [B, H, T, d]
//   views; rows at or past T arrive as zeros. S = Q K^T runs as wgmma
//   m64n64k16 with both operands K-major from swizzled shared memory; p goes
//   from the S accumulator, rounded to bf16, straight in as the register A
//   operand of O += P V (m64n{d}k16; at d = 256 two m64n128k16), whose B
//   operand V is read as stored ([keys][d]: MN-major) through wgmma's
//   transpose bit: no transposed copy of V. The consumer issues tile j's S
//   and then tile j - 1's P V, and runs tile j's softmax while the tensor
//   cores do that P V (the rescale of O waits for it). Scores are kept in
//   log2 units (exp2).
//   Tiles without a visible key are skipped by the backward's rule: each
//   block finds the first visible key of the kv tiles it may meet (one warp
//   ballot per 64 keys of the mask) and visits a kv tile only when that key
//   is at most its last row (causal) or below T. Blocks run longest first:
//   under causal masking the last q tile, which meets the most kv tiles,
//   with a GQA group's heads side by side.
//   A masked score gives p = 0 exactly (not exp(-1e30 - m)), so a query row
//   with no visible key ends with l = 0 and m = -1e30: out = 0 and lse =
//   -1e30 + log(1e-30), finite, whether or not its q tile visits any tile.
//   Rows with a visible key get the TPU kernel's result.
// - f32: the products as f32 FMAs from shared memory (no tensor cores: TF32
//   would lose the f32 inputs' precision), 256 threads in a 16 x 16 grid.
//
// Head dims: the kernels are built for d = 64, 128 and 256. The wrapper
// (ops/flash_attention_vjp.py) runs any other d <= 256 at the next of these
// on copies of q, k and v zero-padded along d, with the scale of the true
// d, and slices out's padded columns off: zero columns add nothing to a
// score, and out's columns past d come out zero. At d = 256 the bf16 kernel
// runs one block an SM (its shared memory, 161 KB, and 128 accumulator
// registers a thread for O leave no room for a second); the f32 kernel
// takes 211 KB of shared memory.
//   It visits every kv tile up to the causal bound; a row with no visible key
//   holds the mean of v over the masked keys it met (finite).
// Past 256 (any multiple of 64; the wrapper pads other d up to one) the wide
// kernels run, with no upper limit on d. A 64-row tile's f32 accumulator
// of out no longer fits one warpgroup's registers (64 x 512 x 4 B is 128 KB
// at d = 512, every register of a warpgroup).
// - bf16 up to FWD_SPLIT_MAX_D = 512 (flash_fwd_split_kernel): one block of
//   two consumer warpgroups a q tile, which split d by 64-column boxes:
//   warpgroup 0 owns the first ceil(nc / 2) of the nc = d / 64 boxes of out,
//   warpgroup 1 the rest (192 + 128 columns at d = 320, 256 + 256 at 512),
//   up to 128 accumulator registers a thread. Q stays in shared memory for
//   the whole kv loop; only K and V stream, a whole tile a unit, through a
//   ring of two units. Each warpgroup computes its partial S = Q K^T over
//   its own boxes, the two trade the partials through 16 KB of shared
//   memory thread by thread and both form the same sum, so both run the
//   same mask and online softmax. Tile j's partial S is issued before tile
//   j - 1's P V, and the exchange and softmax of tile j run while the
//   tensor cores do that P V.
//   There is no producer warp (a block of more than 256 threads leaves too
//   few registers a thread for the accumulators, up to 255 with no spill):
//   each warpgroup's first thread loads that warpgroup's boxes. Shared
//   memory at d = 512: 64 KB of Q, a ring of two 64 KB units, the 16 KB
//   exchange, barriers and two bits a kv tile: ~214 KB, one block an SM.
// - past 512, and f32 at every d past 256, the column-group kernels: a
//   block owns a column group of out (WIDE_OD = 256 columns, the
//   accumulator of d = 256) and recomputes the scores over the whole of d:
//   the producer streams 64-column chunks of Q and K through a ring of four
//   32 KB units (flash_wgmma.cuh's Ring), then the group's columns of V, and
//   the consumer waits for each product before the next. Every group runs
//   the same score products in the same order, so m, l and the lse group 0
//   writes agree. The f32 wide kernel does the same with FMAs over
//   64-column chunks staged transposed. The cost over d = 256's kernels:
//   the scores are computed ceil(d / 256) times, and Q and K are read again
//   for each group.
// The library records what each accepted launch ran (the kind of kernel and
// its threads a block): flash_attention_fwd_last_launch.
//
// What bounds it on the H100. The work is 4*T^2*d multiply-adds per (b, h),
// halved by the causal skip; the bytes are q, k, v, out once. At the GRPO
// scoring shapes (T ~ 320, d = 128) that is about 100 operations per byte:
// under the bf16 tensor-core ridge (~295), so the card's bound is memory. The
// bf16 kernel's own limits are the short kv loop at small T (a q tile meets
// at most T / 64 kv tiles, so the ring barely fills and each block pays its
// setup, Q load and first K/V load in full) and, at long T, latency: two
// 64-row warpgroups an SM (registers allow no third) and 64 x 64 score
// tiles leave the tensor cores idle between dependent steps. Past 256 the
// blocks re-read K and V from L2 for every q tile: the split kernel moves
// 2 d x 128 bytes a (q tile, kv tile) pair (128 KB at d = 512) against the
// column groups' (2 nc + nb) x 8 KB for each of their ceil(d / 256) blocks
// (320 KB at d = 512). PERF.md holds the times beside the bound.

#include "flash_wgmma.cuh"

namespace {

using namespace flash;

constexpr float NEG = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* mask;  // [B, T] or null
  void* out;        // [B, H, T, d] contiguous
  float* lse;       // [B, H, T]
  int B, H, Hkv, T;
  long long sqb, sqh, sqt, skb, skh, skt, svb, svh, svt;
  int causal;
  float scale;
};

// ------------------------------ bf16: wgmma -------------------------------- //

template <int HD>
__global__ void __launch_bounds__(WG_NT, HD > 128 ? 1 : 2)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const Params p) {
  constexpr int TB = tile_bytes<HD>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int nt = (p.T + BK - 1) / BK;
  // block order: the q tile slowest, then b, then the head (a GQA group's
  // heads side by side); under causal masking the last q tile, which meets
  // the most kv tiles, first
  const int slot = blockIdx.x / (p.B * p.H);
  const int qt = p.causal ? nt - 1 - slot : slot;
  const int b = blockIdx.x / p.H % p.B;
  const int h = blockIdx.x % p.H;
  const int q0 = qt * BQ;
  const int hk = h / (p.H / p.Hkv);
  // kv tile kt carries a visible key for some row of this q tile iff its
  // first visible key is at most limit; causal: kv tiles past the q tile's
  // last row never do
  const int limit = p.causal ? min(q0 + BQ - 1, p.T - 1) : p.T - 1;
  const int kt_end = p.causal ? qt + 1 : nt;
  const Smem<HD, 1, true> sm = smem_setup<HD, 1, true>(smem_raw, p.mask, p.T, b, 0, kt_end);
  const int* first = sm.first;

  if (threadIdx.x >= NCONS) {  // producer warp: one thread issues every load
    if (threadIdx.x == NCONS) {
      mbar_expect_tx(sm.res_bar(), TB);
      load_tile<HD>(sm.res(0), &tq, sm.res_bar(), q0, h, b);
      Pipe pipe;  // K on full / empty, V on full_b / empty_b
      for (int kt = 0; kt < kt_end; ++kt) {
        if (first[kt] > limit) continue;
        const uint32_t s = sm.stage(pipe.stage);
        mbar_wait(sm.empty(pipe.stage), pipe.phase ^ 1u);
        mbar_expect_tx(sm.full(pipe.stage), TB);
        load_tile<HD>(s, &tk, sm.full(pipe.stage), kt * BK, hk, b);
        mbar_wait(sm.empty_b(pipe.stage), pipe.phase ^ 1u);
        mbar_expect_tx(sm.full_b(pipe.stage), TB);
        load_tile<HD>(s + TB, &tv, sm.full_b(pipe.stage), kt * BK, hk, b);
        pipe.advance();
      }
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2);  // this thread's rows r0, r0 + 8 of the tile
  const int c0 = (lane & 3) * 2;           // and its column pairs c0 + 8 n
  const auto next_tile = [&](int kt) {
    while (kt < kt_end && first[kt] > limit) ++kt;
    return kt;
  };
  const long long bh = (long long)b * p.H + h;
  const int qrow[2] = {q0 + r0, q0 + r0 + 8};
  // scores in log2 units: p = exp2(s * scale * log2(e) - m)
  const float scale2 = p.scale * 1.4426950408889634f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float o[HD / 2];
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) o[j] = 0.f;
  float s[32];
  uint32_t a[4][4];  // P of the tile whose P V is pending, as the A operand
  Pipe pending;      // that tile's place in the ring
  bool has_pending = false;

  mbar_wait(sm.res_bar(), 0);
  Pipe pipe;
  for (int kt = next_tile(0); kt < kt_end; kt = next_tile(kt + 1)) {
    const int k0 = kt * BK;
    unsigned vis = 0;  // this thread's 16 key columns: 8 n + c0 + e at bit 2 n + e
#pragma unroll
    for (int i = 0; i < 16; ++i)
      vis |= (unsigned)key_visible(p.mask, p.T, b, k0 + (i >> 1) * 8 + c0 + (i & 1)) << i;
    mbar_wait(sm.full(pipe.stage), pipe.phase);
    const uint32_t ks = sm.stage(pipe.stage);

    // S = Q K^T of this tile (64 q rows x 64 keys, K-major operands), then
    // O += round(P) V of the previous one (V read as stored, [keys][HD]:
    // MN-major, 16 keys a step), so that this tile's softmax runs while the
    // tensor cores do the previous tile's P V
    fence_acc(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = kmajor_step(kk);
      wgmma_ss(s, desc_sw128(sm.res(0) + off), desc_sw128(ks + off), kk > 0);
    }
    wgmma_commit();
    if (has_pending) {
      mbar_wait(sm.full_b(pending.stage), pending.phase);
      const uint32_t vs = sm.stage(pending.stage) + TB;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_wide<HD>(o, a[kk], vs + kk * 2048, 1);
      wgmma_commit();
      wgmma_wait<1>();  // S is done; P V may still run
    } else {
      wgmma_wait<0>();
    }
    fence_acc(s);
    mbar_arrive(sm.empty(pipe.stage));  // K of this tile is read

    // mask and online softmax; j = 4 n + 2 i + e is row r0 + 8 i, column
    // 8 n + c0 + e. A row's max is over the 4 threads of its quad.
    unsigned ok = 0;
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int i = (j >> 1) & 1;
      const int col = (j >> 2) * 8 + c0 + (j & 1);
      const bool seen =
          ((vis >> (2 * (j >> 2) + (j & 1))) & 1u) && (!p.causal || k0 + col <= qrow[i]);
      ok |= (unsigned)seen << j;
      s[j] = seen ? s[j] * scale2 : NEG;
      mx[i] = fmaxf(mx[i], s[j]);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int i = (j >> 1) & 1;
      s[j] = ((ok >> j) & 1u) ? exp2f(s[j] - m[i]) : 0.f;
      sum[i] += s[j];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
    }

    if (has_pending) {  // the previous tile's P V is done: free its V
      wgmma_wait<0>();
      fence_acc(o);
      fence_a(a);
      mbar_arrive(sm.empty_b(pending.stage));
    }
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(a[kk], s, kk);
    pending = pipe;
    has_pending = true;
    pipe.advance();
  }
  if (has_pending) {  // the last tile's P V
    mbar_wait(sm.full_b(pending.stage), pending.phase);
    fence_acc(o);
    wgmma_fence();
    const uint32_t vs = sm.stage(pending.stage) + TB;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_wide<HD>(o, a[kk], vs + kk * 2048, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
    fence_a(a);
    mbar_arrive(sm.empty_b(pending.stage));
  }

  bf16* og = static_cast<bf16*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qrow[i] < p.T) {
      const float lc = fmaxf(l[i], 1e-30f);
      const long long row = bh * p.T + qrow[i];
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<uint32_t*>(&og[row * HD + n * 8 + c0]) =
            pack_bf16(o[4 * n + 2 * i] / lc, o[4 * n + 2 * i + 1] / lc);
      // back from log2 units; a row with no visible key keeps m = -1e30
      if ((lane & 3) == 0) p.lse[row] = (m[i] == NEG ? NEG : m[i] * 0.6931471805599453f) + logf(lc);
    }
  }
}

// ------------------------------ f32: FMAs ---------------------------------- //

constexpr int NT = 256;  // 16 x 16 threads: rows ty + 16 i, cols tx + 16 j

template <int HD>
constexpr int f32_smem_bytes() {
  return (HD * (BQ + 1) + HD * (BK + 1) + BK * HD + BQ * (BK + 1)) * 4 + BK * 4;
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD>
__global__ void __launch_bounds__(NT) flash_fwd_f32_kernel(const Params p) {
  constexpr int RI = BQ / 16;  // query rows per thread
  constexpr int CJ = BK / 16;  // score columns per thread
  constexpr int OJ = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qt = smem;                      // [HD][BQ + 1]
  float* Kt = Qt + HD * (BQ + 1);        // [HD][BK + 1]
  float* Vs = Kt + HD * (BK + 1);        // [BK][HD]
  float* Ps = Vs + BK * HD;              // [BQ][BK + 1]
  int* pm = reinterpret_cast<int*>(Ps + BQ * (BK + 1));  // [BK] key visible

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = blockIdx.x * BQ;
  const int seq = p.T;

  const float* qg = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
  const float* kg = static_cast<const float*>(p.k) + b * p.skb + hk * p.skh;
  const float* vg = static_cast<const float*>(p.v) + b * p.svb + hk * p.svh;

  for (int e = tid; e < BQ * HD; e += NT) {
    const int r = e / HD, c = e - (e / HD) * HD;
    const int row = q0 + r;
    Qt[c * (BQ + 1) + r] = row < seq ? qg[row * p.sqt + c] : 0.f;
  }

  float m[RI], l[RI], o[RI][OJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < OJ; ++j) o[i][j] = 0.f;
  }

  const int kv_end = p.causal ? min(seq, q0 + BQ) : seq;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * HD; e += NT) {
      const int r = e / HD, c = e - (e / HD) * HD;
      const int key = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (key < seq) {
        kx = kg[key * p.skt + c];
        vx = vg[key * p.svt + c];
      }
      Kt[c * (BK + 1) + r] = kx;
      Vs[r * HD + c] = vx;
    }
    if (tid < BK) {
      const int key = k0 + tid;
      pm[tid] = key < seq && (p.mask == nullptr || p.mask[(long long)b * seq + key] > 0);
    }
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < HD; ++kk) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qt[kk * (BQ + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = Kt[kk * (BK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qrow = q0 + ty + 16 * i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = tx + 16 * j;
        const bool ok = pm[col] && (!p.causal || k0 + col <= qrow);
        s[i][j] = ok ? s[i][j] * p.scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float pr = expf(s[i][j] - m_new);
        sum += pr;
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = pr;
      }
      l[i] = l[i] * alpha + sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < OJ; ++j) o[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RI], vv[OJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < OJ; ++j) vv[j] = Vs[kk * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < OJ; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
    }
  }

  float* og = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < seq) {
      const float lc = fmaxf(l[i], 1e-30f);
      const long long base = ((long long)bh * seq + row);
#pragma unroll
      for (int j = 0; j < OJ; ++j) og[base * HD + tx + 16 * j] = o[i][j] / lc;
      if (tx == 0) p.lse[base] = m[i] + logf(lc);
    }
  }
}

// ------ bf16, 256 < d <= FWD_SPLIT_MAX_D: two warpgroups split the head dim ------ //
//
// A q tile is one block of two warpgroups; warpgroup w owns a contiguous run
// of NB_w 64-column boxes of d (NB_0 = ceil(nc / 2)), in out and in the
// score product alike. Thread 0 loads Q once. K and V stream through a ring
// of SPLIT_STAGES units of nc boxes in the sequence K(j0), K(j1), V(j0), K(j2),
// V(j1), ..., V(jn) over the visited kv tiles j0 < j1 < ..., the order in
// which the products read them. Each warpgroup loads and reads only its own
// boxes of a unit, so each runs its own pipeline over the shared slots: its
// first thread issues its boxes of the first two units, then, each time
// one of its products that read a unit is done (it waits for it anyway), its
// boxes of the unit two further on, into the same slot. A full barrier
// per (warpgroup, slot) carries the bytes; no empty barrier is needed, as
// the thread that refills a slot's boxes has itself waited for the wgmma
// that read them. For visited tile j, warpgroup w:
//   1. issues its partial S_w = Q[:, cols_w] K[:, cols_w]^T (m64n64k16 over
//      its boxes), then the previous tile's O_w += P V[:, cols_w] (m64nNk16,
//      N = 64 NB_w, V read as stored through the transpose bit) and waits
//      for S_w alone;
//   2. refills K's slot (where it would wait for the other warpgroup) and
//      trades the partials through one [32][128] f32 buffer, thread t of
//      one warpgroup with thread t of the other (they hold the same rows and
//      columns of a 64 x 64 accumulator): warpgroup 1 writes S_1 and arrives
//      on named barrier 1; warpgroup 0 waits there, reads S_1, writes S_0 in
//      its place and arrives on barrier 2; warpgroup 1 waits there and reads
//      S_0. Each forms S_0 + S_1 (float addition commutes: the same bits);
//   3. runs the mask and online softmax of the built head dims on that S
//      (both warpgroups alike, so m, l and p agree; a tile whose 64 keys are
//      all visible to every row skips the per-element mask); once P V is
//      done, refills V's slot, rescales O (unless a warp's rows all kept
//      their max) and packs p, rounded to bf16, as the next A operand.
//      Warpgroup 0 writes lse.
// The two named barriers order every use of the exchange buffer: warpgroup
// 1 writes tile j + 1's S_1 only after barrier 2 of tile j, warpgroup 0
// overwrites it only after barrier 1 of tile j + 1. Which kv tiles a block
// visits, and which of them are fully visible, are bits in shared memory
// (the skip rule below), 8 bytes per 32 kv tiles: every T the column-group
// kernel takes launches. Every wgmma is waited for on every path, with no
// branch between it and its wait, and every branch around one is
// warp-uniform (values broadcast from lane 0): ptxas keeps the products
// asynchronous.

constexpr int FWD_SPLIT_MAX_D = 512;
constexpr int FWD_SPLIT_NT = 2 * NCONS;      // two consumer warpgroups, no producer warp
// ring units: K of one tile and V of the one before, both read by the
// products a tile issues together; the most that fits at d = 512, and at
// d = 320 faster than a ring of four (PERF.md)
constexpr int SPLIT_STAGES = 2;
constexpr int SPLIT_XCHG = 32 * NCONS * 4;   // the partial S exchange: [32][NCONS] f32, 16 KB
constexpr int SMEM_OPTIN = 232448;           // shared memory a block may use on sm_90

// alignment slack; Q and SPLIT_STAGES units of nc boxes; the exchange; full
// [2][SPLIT_STAGES] and Q's barrier; two bits a kv tile (visited, fully
// visible). At d = 512 and the column-group kernel's largest T (25,072 kv
// tiles) 220,328 bytes.
__host__ __device__ constexpr int split_smem_bytes(int nc, int nt) {
  return 1024 + (1 + SPLIT_STAGES) * nc * BOX + SPLIT_XCHG + (2 * SPLIT_STAGES + 1) * 8 +
         8 * ((nt + 31) / 32);
}

struct SplitSmem {
  uint32_t base;  // 1024-aligned
  int nc;
  __device__ __forceinline__ uint32_t q() const { return base; }
  __device__ __forceinline__ uint32_t unit(int s) const { return base + (1 + s) * nc * BOX; }
  __device__ __forceinline__ uint32_t xchg() const { return unit(SPLIT_STAGES); }
  __device__ __forceinline__ uint32_t full(int wg, int s) const {
    return xchg() + SPLIT_XCHG + 8 * (wg * SPLIT_STAGES + s);
  }
  __device__ __forceinline__ uint32_t q_bar() const { return full(2, 0); }
  __device__ __forceinline__ uint32_t bits() const { return q_bar() + 8; }
};

// Ring position, the same sequence for a warpgroup's loader and its consumers.
struct SPipe {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == SPLIT_STAGES) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// Named barrier `id` (1 ..) over `n` threads: wait for it, or arrive without waiting.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ float ld_shared_f32(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ void st_shared_f32(uint32_t a, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(a), "f"(v) : "memory");
}

// 2^x, flushing a subnormal result to 0 (one MUFU.EX2; exp2f adds a
// rescale for subnormal results, which a p below 2^-126 does not need)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// O += A V over this warpgroup's NB = 2, 3 or 4 boxes of V's columns
// (MN-major at shared address v): accumulator j of o is column 8 (j / 4) +
// (lane % 4) * 2 + j % 2, so columns 0-127 are o[0 .. 63] and 128-255
// o[64 .. 127]
template <int NB>
__device__ __forceinline__ void pv_boxes(float (&o)[NB * 32], const uint32_t (&a)[4], uint32_t v) {
  static_assert(NB >= 2 && NB <= 4, "a warpgroup owns 2 to 4 boxes");
  wgmma_rs(*reinterpret_cast<float(*)[64]>(&o[0]), a, desc_sw128_mn(v, BOX), 1);
  if constexpr (NB == 3)
    wgmma_rs(*reinterpret_cast<float(*)[32]>(&o[64]), a, desc_sw128_mn(v + 2 * BOX, BOX), 1);
  if constexpr (NB == 4)
    wgmma_rs(*reinterpret_cast<float(*)[64]>(&o[64]), a, desc_sw128_mn(v + 2 * BOX, BOX), 1);
}

// A split block's place, as its consumers read it.
struct SplitCtx {
  const Params& p;
  const CUtensorMap* tk;
  const CUtensorMap* tv;
  const unsigned* bits;  // [0, nw): visited kv tiles; [nw, 2 nw): fully visible ones
  SplitSmem sm;
  int b, hk, q0, kt_end, nw;
  // the first visited kv tile at or after kt (kt_end if none)
  __device__ __forceinline__ int next_tile(int kt) const {
    while (kt < kt_end) {
      const unsigned w = bits[kt >> 5] >> (kt & 31);
      if (w) return kt + __ffs(w) - 1;
      kt = (kt | 31) + 1;
    }
    return kt_end;
  }
  // the same, broadcast from lane 0 so that ptxas sees a loop over it as
  // warp-uniform (all lanes call it)
  __device__ __forceinline__ int next_tile_uniform(int kt) const {
    return __shfl_sync(0xffffffffu, next_tile(kt), 0);
  }
  __device__ __forceinline__ bool fully_visible(int kt) const {
    return (bits[nw + (kt >> 5)] >> (kt & 31)) & 1u;
  }
};

// A warpgroup's running state: the online softmax's m and l, its NB boxes
// of O, the scores, P of the tile whose P V is pending (the A operand), its
// place in the ring, and its first thread's load cursor (the next tiles
// whose K and V it loads, the K and V units it issued).
template <int NB>
struct SplitRows {
  float m[2], l[2];
  float o[NB * 32];
  float s[32];
  uint32_t a[4][4];
  SPipe pipe, load;
  int pk, pv, nk, nv;
};

// The first thread of warpgroup wg: its NB boxes of d from b0 of the next
// unit of the sequence, if any, into the ring's next slot.
template <int NB>
__device__ __forceinline__ void split_load(const SplitCtx& cx, int wg, int b0, SplitRows<NB>& r) {
  if (threadIdx.x % NCONS != 0 || r.pv >= cx.kt_end) return;
  const bool is_k = r.pk < cx.kt_end && r.nk <= r.nv + 1;  // K(j0), K(j1), V(j0), K(j2), ...
  const int kt = is_k ? r.pk : r.pv;
  const uint32_t u = cx.sm.unit(r.load.stage), full = cx.sm.full(wg, r.load.stage);
  const CUtensorMap* map = is_k ? cx.tk : cx.tv;
  mbar_expect_tx(full, NB * BOX);
#pragma unroll
  for (int c = b0; c < b0 + NB; ++c)
    tma_load_4d(u + c * BOX, map, full, c * 64, kt * BK, cx.hk, cx.b);
  if (is_k) {
    r.pk = cx.next_tile(r.pk + 1);
    ++r.nk;
  } else {
    r.pv = cx.next_tile(r.pv + 1);
    ++r.nv;
  }
  r.load.advance();
}

// Mask (MASKED) and online softmax of one tile's S, as the kernels of the
// built head dims: s becomes p, alpha the factor of the thread's two rows.
template <bool MASKED, int NB>
__device__ __forceinline__ void split_softmax(const SplitCtx& cx, int k0, SplitRows<NB>& r,
                                              float (&alpha)[2]) {
  const Params& p = cx.p;
  const int t = threadIdx.x % NCONS, lane = t & 31;
  const int c0 = (lane & 3) * 2;                            // this thread's column pairs c0 + 8 n
  const int qrow0 = cx.q0 + (t >> 5) * 16 + (lane >> 2);  // and rows qrow0, qrow0 + 8
  const float scale2 = p.scale * 1.4426950408889634f;     // scores in log2 units
  float(&s)[32] = r.s;
  unsigned ok = 0xffffffffu;
  float mx[2] = {NEG, NEG};
  if constexpr (MASKED) {
    unsigned vis = 0;  // this thread's 16 key columns: 8 n + c0 + e at bit 2 n + e
#pragma unroll
    for (int i = 0; i < 16; ++i)
      vis |= (unsigned)key_visible(p.mask, p.T, cx.b, k0 + (i >> 1) * 8 + c0 + (i & 1)) << i;
    ok = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int i = (j >> 1) & 1;
      const int col = (j >> 2) * 8 + c0 + (j & 1);
      const bool seen =
          ((vis >> (2 * (j >> 2) + (j & 1))) & 1u) && (!p.causal || k0 + col <= qrow0 + 8 * i);
      ok |= (unsigned)seen << j;
      s[j] = seen ? s[j] * scale2 : NEG;
      mx[i] = fmaxf(mx[i], s[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 32; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    // unmasked, mx is the max of the raw scores: scaling is monotonic, so
    // mx * scale2 is the max of the scaled ones
    const float m_new = fmaxf(r.m[i], MASKED ? mx[i] : mx[i] * scale2);
    alpha[i] = ex2(r.m[i] - m_new);
    r.m[i] = m_new;
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int i = (j >> 1) & 1;
    if constexpr (MASKED)
      s[j] = ((ok >> j) & 1u) ? ex2(s[j] - r.m[i]) : 0.f;
    else
      s[j] = ex2(fmaf(s[j], scale2, -r.m[i]));
    sum[i] += s[j];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    r.l[i] = r.l[i] * alpha[i] + sum[i];
  }
}

// One visited kv tile kt for warpgroup wg, which owns the NB boxes of d
// from b0 (steps 1-3 above; PENDING: the previous tile's P V is issued
// beside S). Every wgmma it issues it waits for on every path.
template <bool PENDING, int NB>
__device__ __forceinline__ void split_tile(const SplitCtx& cx, int wg, int b0, int kt,
                                           SplitRows<NB>& r) {
  const SplitSmem& sm = cx.sm;
  const int k0 = kt * BK;
  mbar_wait(sm.full(wg, r.pipe.stage), r.pipe.phase);
  const uint32_t ks = sm.unit(r.pipe.stage);
  r.pipe.advance();

  __syncwarp();
  fence_acc(r.o);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < NB; ++c) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t off = (b0 + c) * BOX + kk * 32;
      wgmma_ss(r.s, desc_sw128(sm.q() + off), desc_sw128(ks + off), c > 0 || kk > 0);
    }
  }
  wgmma_commit();
  if constexpr (PENDING) {  // V of the previous tile is the next unit
    mbar_wait(sm.full(wg, r.pipe.stage), r.pipe.phase);
    const uint32_t vs = sm.unit(r.pipe.stage);
    r.pipe.advance();
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pv_boxes<NB>(r.o, r.a[kk], vs + b0 * BOX + kk * 2048);
    wgmma_commit();
    wgmma_wait<1>();  // S is done; P V may still run
  } else {
    wgmma_wait<0>();
  }
  fence_acc(r.s);

  // S = S_0 + S_1 (j = 4 n + 2 i + e is row r0 + 8 i, column 8 n + c0 + e);
  // this warpgroup's boxes of K are read: its loader refills them where the
  // warpgroup would wait for the other one
  const uint32_t xs = sm.xchg() + (threadIdx.x % NCONS) * 4;  // this thread's column
  float(&s)[32] = r.s;
  if (wg == 1) {
#pragma unroll
    for (int j = 0; j < 32; ++j) st_shared_f32(xs + j * NCONS * 4, s[j]);
    bar_arrive(1, FWD_SPLIT_NT);
    split_load<NB>(cx, wg, b0, r);
    __syncwarp();
    bar_sync(2, FWD_SPLIT_NT);
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = ld_shared_f32(xs + j * NCONS * 4) + s[j];
  } else {
    split_load<NB>(cx, wg, b0, r);
    __syncwarp();
    bar_sync(1, FWD_SPLIT_NT);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float s1 = ld_shared_f32(xs + j * NCONS * 4);
      st_shared_f32(xs + j * NCONS * 4, s[j]);
      s[j] += s1;
    }
    bar_arrive(2, FWD_SPLIT_NT);
  }

  // a tile whose keys every row of the q tile sees takes no mask
  float alpha[2];
  if (__shfl_sync(0xffffffffu,
                  (int)(cx.fully_visible(kt) && (!cx.p.causal || k0 + BK - 1 <= cx.q0)), 0))
    split_softmax<false>(cx, k0, r, alpha);
  else
    split_softmax<true>(cx, k0, r, alpha);

  if constexpr (PENDING) {  // the previous tile's P V is done: refill V's slot
    wgmma_wait<0>();
    fence_acc(r.o);
    fence_a(r.a);
    split_load<NB>(cx, wg, b0, r);
    __syncwarp();
  }
  // O rescaled unless the warp's rows all kept their max (alpha = 1)
  if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
    for (int j = 0; j < NB * 32; ++j) r.o[j] *= alpha[(j >> 1) & 1];
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) acc_to_a(r.a[kk], s, kk);
}

// Warpgroup wg's part of a split block: its loads of the first units, the
// visited kv tiles in order (the first with no pending P V), the last
// tile's P V, then its NB boxes of out and (warpgroup 0) lse.
template <int NC, int NB>
__device__ __forceinline__ void split_rows(const SplitCtx& cx, int wg) {
  const int b0 = wg == 0 ? 0 : (NC + 1) / 2;
  const Params& p = cx.p;
  const SplitSmem& sm = cx.sm;
  SplitRows<NB> r;
  r.m[0] = r.m[1] = NEG;
  r.l[0] = r.l[1] = 0.f;
#pragma unroll
  for (int j = 0; j < NB * 32; ++j) r.o[j] = 0.f;
  r.pipe = r.load = SPipe();
  r.pk = r.pv = cx.next_tile(0);
  r.nk = r.nv = 0;
  for (int i = 0; i < SPLIT_STAGES; ++i) split_load<NB>(cx, wg, b0, r);
  __syncwarp();

  mbar_wait(sm.q_bar(), 0);
  int kt = cx.next_tile_uniform(0);
  if (kt < cx.kt_end) {
    split_tile<false, NB>(cx, wg, b0, kt, r);
    for (kt = cx.next_tile_uniform(kt + 1); kt < cx.kt_end; kt = cx.next_tile_uniform(kt + 1))
      split_tile<true, NB>(cx, wg, b0, kt, r);
    // the last tile's P V
    mbar_wait(sm.full(wg, r.pipe.stage), r.pipe.phase);
    const uint32_t vs = sm.unit(r.pipe.stage);
    __syncwarp();
    fence_acc(r.o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pv_boxes<NB>(r.o, r.a[kk], vs + b0 * BOX + kk * 2048);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(r.o);
    fence_a(r.a);
  }

  const int t = threadIdx.x % NCONS, lane = t & 31;
  const int c0 = (lane & 3) * 2;
  const int qrow0 = cx.q0 + (t >> 5) * 16 + (lane >> 2);
  const long long bh = (long long)cx.b * p.H + blockIdx.x % p.H;
  bf16* og = static_cast<bf16*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qrow = qrow0 + 8 * i;
    if (qrow < p.T) {
      const float lc = fmaxf(r.l[i], 1e-30f);
      const long long row = bh * p.T + qrow;
#pragma unroll
      for (int n = 0; n < NB * 8; ++n)
        *reinterpret_cast<uint32_t*>(&og[row * NC * 64 + b0 * 64 + n * 8 + c0]) =
            pack_bf16(r.o[4 * n + 2 * i] / lc, r.o[4 * n + 2 * i + 1] / lc);
      // back from log2 units; a row with no visible key keeps m = -1e30
      if (wg == 0 && (lane & 3) == 0)
        p.lse[row] = (r.m[i] == NEG ? NEG : r.m[i] * 0.6931471805599453f) + logf(lc);
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(FWD_SPLIT_NT, 1)
    flash_fwd_split_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int nt = (p.T + BK - 1) / BK;
  // block order: the q tile slowest, then b, then the head (a GQA group's
  // heads side by side); under causal masking the last q tile first
  const int slot = blockIdx.x / (p.B * p.H);
  const int qt = p.causal ? nt - 1 - slot : slot;
  const int b = blockIdx.x / p.H % p.B;
  const int h = blockIdx.x % p.H;
  const int q0 = qt * BQ;
  const int limit = p.causal ? min(q0 + BQ - 1, p.T - 1) : p.T - 1;
  const int kt_end = p.causal ? qt + 1 : nt;
  const int nw = (kt_end + 31) / 32;
  const SplitSmem sm{(smem_u32(smem_raw) + 1023u) & ~1023u, NC};
  unsigned* bits = reinterpret_cast<unsigned*>(smem_raw + (sm.bits() - smem_u32(smem_raw)));

  for (int i = threadIdx.x; i < 2 * nw; i += FWD_SPLIT_NT) bits[i] = 0u;
  if (threadIdx.x == 0) {
    for (int w = 0; w < 2; ++w)
      for (int s = 0; s < SPLIT_STAGES; ++s) mbar_init(sm.full(w, s), 1);
    mbar_init(sm.q_bar(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(sm.q_bar(), NC * BOX);
    for (int c = 0; c < NC; ++c) tma_load_4d(sm.q() + c * BOX, &tq, sm.q_bar(), c * 64, q0, h, b);
  }
  __syncthreads();
  // the skip rule: kv tile kt is visited iff its first visible key is at
  // most limit; fully visible iff all its 64 keys are (one warp a tile)
  const int lane = threadIdx.x & 31;
  for (int kt = (int)(threadIdx.x >> 5); kt < kt_end; kt += FWD_SPLIT_NT / 32) {
    const int k0 = kt * BK;
    const int f = first_visible_key(p.mask, p.T, b, k0);
    const bool all = __all_sync(0xffffffffu, key_visible(p.mask, p.T, b, k0 + lane) &&
                                                 key_visible(p.mask, p.T, b, k0 + 32 + lane));
    if (lane == 0 && f <= limit) atomicOr(&bits[kt >> 5], 1u << (kt & 31));
    if (lane == 0 && all) atomicOr(&bits[nw + (kt >> 5)], 1u << (kt & 31));
  }
  __syncthreads();

  const SplitCtx cx{p, &tk, &tv, bits, sm, b, h / (p.H / p.Hkv), q0, kt_end, nw};
  // the warpgroup broadcast from lane 0: a warp-uniform value for ptxas.
  // Warpgroups that own as many boxes run one code path: two paths are two
  // instruction streams for the SM to fetch (0.108 against 0.083-0.096 ms
  // at d = 512, PERF.md)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / NCONS, 0);
  if constexpr (NC % 2 == 0)
    split_rows<NC, NC / 2>(cx, wg);
  else if (wg == 0)
    split_rows<NC, (NC + 1) / 2>(cx, 0);
  else
    split_rows<NC, NC / 2>(cx, 1);
}

// --------------------- wide head dims (d > 256): both types ----------------- //
//
// Past FWD_SPLIT_MAX_D (bf16) and at every d past 256 (f32).
// A block owns one (b, head, 64-row q tile) and one column group of out: OD
// columns. The f32 accumulator of a whole row would take the register file
// (64 x 512 x 4 B = 128 KB at d = 512), so each group's block recomputes the
// scores over the whole of d, accumulated over 64-column chunks of Q and K
// streamed through shared memory, and keeps only its own columns of out.
// Every group computes the same scores in the same order, so m and l, and
// the lse that group 0 writes, are one value for all of them.

constexpr int WIDE_OD = 256;  // output columns a forward block owns

// bf16: the chunk unit holds Q's and K's boxes c; the V unit the group's
// columns of V (nb boxes; in a last group narrower than OD the boxes past d
// are not loaded, and the accumulator columns they feed are never stored:
// the columns of P V are independent). Each product waits for the one before.
__global__ void __launch_bounds__(WG_NT, 1)
    flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Params p, int d) {
  constexpr int OD = WIDE_OD;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int nc = d / 64;
  const int ng = (d + OD - 1) / OD;
  const int nt = (p.T + BK - 1) / BK;
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
          const BoxLoad qk[2] = {{&tq, c * 64, q0, h}, {&tk, c * 64, kt * BK, hk}};
          feed(ring, pipe, qk, 2, b);
        }
        BoxLoad vl[OD / 64];
#pragma unroll
        for (int i = 0; i < OD / 64; ++i) vl[i] = BoxLoad{&tv, (cg * (OD / 64) + i) * 64, kt * BK, hk};
        feed(ring, pipe, vl, nb, b);
      }
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2);
  const int c0 = (lane & 3) * 2;
  const long long bh = (long long)b * p.H + h;
  const int qrow[2] = {q0 + r0, q0 + r0 + 8};
  const float scale2 = p.scale * 1.4426950408889634f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float o[OD / 2];
#pragma unroll
  for (int j = 0; j < OD / 2; ++j) o[j] = 0.f;

  WPipe pipe;
  for (int kt = 0; kt < kt_end; ++kt) {
    if (first[kt] > limit) continue;
    const int k0 = kt * BK;
    unsigned vis = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      vis |= (unsigned)key_visible(p.mask, p.T, b, k0 + (i >> 1) * 8 + c0 + (i & 1)) << i;

    // S = Q K^T over the chunks of d
    float s[32];
    for (int c = 0; c < nc; ++c) {
      mbar_wait(ring.full(pipe.stage), pipe.phase);
      const uint32_t u = ring.unit(pipe.stage);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(s, desc_sw128(u + kk * 32), desc_sw128(u + BOX + kk * 32), c > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);
      mbar_arrive(ring.empty(pipe.stage));
      pipe.advance();
    }

    // mask and online softmax, as the kernels of the built head dims
    unsigned ok = 0;
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int i = (j >> 1) & 1;
      const int col = (j >> 2) * 8 + c0 + (j & 1);
      const bool seen =
          ((vis >> (2 * (j >> 2) + (j & 1))) & 1u) && (!p.causal || k0 + col <= qrow[i]);
      ok |= (unsigned)seen << j;
      s[j] = seen ? s[j] * scale2 : NEG;
      mx[i] = fmaxf(mx[i], s[j]);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int i = (j >> 1) & 1;
      s[j] = ((ok >> j) & 1u) ? exp2f(s[j] - m[i]) : 0.f;
      sum[i] += s[j];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
    }
#pragma unroll
    for (int j = 0; j < OD / 2; ++j) o[j] *= alpha[(j >> 1) & 1];

    // O += round(P) V over the group's columns (V read as stored: MN-major)
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(a[kk], s, kk);
    mbar_wait(ring.full(pipe.stage), pipe.phase);
    const uint32_t vs = ring.unit(pipe.stage);
    fence_acc(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_wide<OD>(o, a[kk], vs + kk * 2048, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
    fence_a(a);
    mbar_arrive(ring.empty(pipe.stage));
    pipe.advance();
  }

  bf16* og = static_cast<bf16*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qrow[i] < p.T) {
      const float lc = fmaxf(l[i], 1e-30f);
      const long long row = bh * p.T + qrow[i];
#pragma unroll
      for (int n = 0; n < OD / 8; ++n) {
        const int col = cg * OD + n * 8 + c0;
        if (col < d)
          *reinterpret_cast<uint32_t*>(&og[row * d + col]) =
              pack_bf16(o[4 * n + 2 * i] / lc, o[4 * n + 2 * i + 1] / lc);
      }
      if (cg == 0 && (lane & 3) == 0)
        p.lse[row] = (m[i] == NEG ? NEG : m[i] * 0.6931471805599453f) + logf(lc);
    }
  }
}

// f32: FMAs as the built head dims' kernel, with Q and K staged transposed
// one 64-column chunk at a time and V staged over the group's columns.
constexpr int WIDE_C = 64;  // columns of a staged chunk

constexpr int f32_wide_smem_bytes() {
  // Qt, Kt [C][BQ + 1]; Vs [BK][OD]; Ps [BQ][BK + 1]; key visible [BK]
  return (2 * WIDE_C * (BQ + 1) + BK * WIDE_OD + BQ * (BK + 1)) * 4 + BK * 4;
}

__global__ void __launch_bounds__(NT) flash_fwd_f32_wide_kernel(const Params p, int d) {
  constexpr int OD = WIDE_OD, C = WIDE_C;
  constexpr int RI = BQ / 16, CJ = BK / 16, OJ = OD / 16;
  extern __shared__ float smem[];
  float* Qt = smem;                // [C][BQ + 1]
  float* Kt = Qt + C * (BQ + 1);   // [C][BK + 1]
  float* Vs = Kt + C * (BK + 1);   // [BK][OD]
  float* Ps = Vs + BK * OD;        // [BQ][BK + 1]
  int* pm = reinterpret_cast<int*>(Ps + BQ * (BK + 1));

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int ng = (d + OD - 1) / OD;
  const int cg = blockIdx.x % ng;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = (blockIdx.x / ng) * BQ;
  const int seq = p.T;

  const float* qg = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
  const float* kg = static_cast<const float*>(p.k) + b * p.skb + hk * p.skh;
  const float* vg = static_cast<const float*>(p.v) + b * p.svb + hk * p.svh;

  float m[RI], l[RI], o[RI][OJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < OJ; ++j) o[i][j] = 0.f;
  }

  const int kv_end = p.causal ? min(seq, q0 + BQ) : seq;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
    for (int cc = 0; cc < d; cc += C) {
      __syncthreads();  // the previous chunk's (or tile's) readers are done
      for (int e = tid; e < BQ * C; e += NT) {
        const int r = e / C, c = e - (e / C) * C;
        const int row = q0 + r;
        Qt[c * (BQ + 1) + r] = row < seq && cc + c < d ? qg[row * p.sqt + cc + c] : 0.f;
      }
      for (int e = tid; e < BK * C; e += NT) {
        const int r = e / C, c = e - (e / C) * C;
        const int key = k0 + r;
        Kt[c * (BK + 1) + r] = key < seq && cc + c < d ? kg[key * p.skt + cc + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < C; ++kk) {
        float qv[RI], kv[CJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) qv[i] = Qt[kk * (BQ + 1) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < CJ; ++j) kv[j] = Kt[kk * (BK + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }
    for (int e = tid; e < BK * OD; e += NT) {
      const int r = e / OD, c = e - (e / OD) * OD;
      const int key = k0 + r, col = cg * OD + c;
      Vs[r * OD + c] = key < seq && col < d ? vg[key * p.svt + col] : 0.f;
    }
    if (tid < BK) {
      const int key = k0 + tid;
      pm[tid] = key < seq && (p.mask == nullptr || p.mask[(long long)b * seq + key] > 0);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qrow = q0 + ty + 16 * i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = tx + 16 * j;
        const bool ok = pm[col] && (!p.causal || k0 + col <= qrow);
        s[i][j] = ok ? s[i][j] * p.scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float pr = expf(s[i][j] - m_new);
        sum += pr;
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = pr;
      }
      l[i] = l[i] * alpha + sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < OJ; ++j) o[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RI], vv[OJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < OJ; ++j) vv[j] = Vs[kk * OD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < OJ; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
    }
  }

  float* og = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < seq) {
      const float lc = fmaxf(l[i], 1e-30f);
      const long long base = ((long long)bh * seq + row);
#pragma unroll
      for (int j = 0; j < OJ; ++j) {
        const int col = cg * OD + tx + 16 * j;
        if (col < d) og[base * d + col] = o[i][j] / lc;
      }
      if (cg == 0 && tx == 0) p.lse[base] = m[i] + logf(lc);
    }
  }
}

// What the last accepted launch ran, as its launcher configured it: the
// kind of kernel and the threads a block (flash_attention_fwd_last_launch).
struct Launch {
  const char* kind;
  int threads;
};
Launch g_last = {"none", 0};

cudaError_t recorded(cudaError_t err, const char* kind, int threads) {
  if (err == cudaSuccess) g_last = Launch{kind, threads};
  return err;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, int bytes, const Params& p, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + BQ - 1) / BQ, p.B * p.H);
  kernel<<<grid, threads, bytes, stream>>>(p);
  return recorded(cudaGetLastError(), "f32", threads);
}

// The bf16 kernel: tensor maps of q, k and v, then one block per (q tile, b,
// head).
template <int HD>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  const auto kernel = flash_fwd_wgmma_kernel<HD>;
  const int nt = (p.T + BK - 1) / BK;
  const int bytes = wgmma_smem_bytes<HD, 1, true>(nt);
  CUtensorMap tq, tk, tv;
  int err = make_map_bf16_4d(&tq, p.q, p.B, p.H, p.T, HD, p.sqb, p.sqh, p.sqt, BQ);
  if (!err) err = make_map_bf16_4d(&tk, p.k, p.B, p.Hkv, p.T, HD, p.skb, p.skh, p.skt, BK);
  if (!err) err = make_map_bf16_4d(&tv, p.v, p.B, p.Hkv, p.T, HD, p.svb, p.svh, p.svt, BK);
  if (err) return static_cast<cudaError_t>(err);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)p.B * p.H * nt;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, WG_NT, bytes, stream>>>(tq, tk, tv, p);
  return recorded(cudaGetLastError(), "wgmma", WG_NT);
}

// The bf16 kernel for 256 < d <= FWD_SPLIT_MAX_D (a multiple of 64): one
// block of two warpgroups per (q tile, b, head), with a ring of as many
// units as fit beside Q, the exchange and the visit bits (at least two).
cudaError_t launch_split(const Params& p, int d, cudaStream_t stream) {
  const int nt = (p.T + BK - 1) / BK;
  const int bytes = split_smem_bytes(d / 64, nt);
  if (bytes > SMEM_OPTIN) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int err = make_map_bf16_4d(&tq, p.q, p.B, p.H, p.T, d, p.sqb, p.sqh, p.sqt, BQ);
  if (!err) err = make_map_bf16_4d(&tk, p.k, p.B, p.Hkv, p.T, d, p.skb, p.skh, p.skt, BK);
  if (!err) err = make_map_bf16_4d(&tv, p.v, p.B, p.Hkv, p.T, d, p.svb, p.svh, p.svt, BK);
  if (err) return static_cast<cudaError_t>(err);
  const auto kernel = d == 320   ? flash_fwd_split_kernel<5>
                      : d == 384 ? flash_fwd_split_kernel<6>
                      : d == 448 ? flash_fwd_split_kernel<7>
                                 : flash_fwd_split_kernel<8>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)p.B * p.H * nt;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, FWD_SPLIT_NT, bytes, stream>>>(tq, tk, tv, p);
  return recorded(cudaGetLastError(), "fwd_split", FWD_SPLIT_NT);
}

// The column-group kernels (d > 256, a multiple of 64): one block per
// (column group, q tile, b, head).
cudaError_t launch_wide(const Params& p, int d, int is_bf16, cudaStream_t stream) {
  const int nt = (p.T + BK - 1) / BK;
  const int ng = (d + WIDE_OD - 1) / WIDE_OD;
  if (!is_bf16) {
    const int bytes = f32_wide_smem_bytes();
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_f32_wide_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    flash_fwd_f32_wide_kernel<<<dim3(nt * ng, p.B * p.H), NT, bytes, stream>>>(p, d);
    return recorded(cudaGetLastError(), "column_groups_f32", NT);
  }
  const int bytes = wide_smem_bytes(nt);
  CUtensorMap tq, tk, tv;
  int err = make_map_bf16_4d(&tq, p.q, p.B, p.H, p.T, d, p.sqb, p.sqh, p.sqt, BQ);
  if (!err) err = make_map_bf16_4d(&tk, p.k, p.B, p.Hkv, p.T, d, p.skb, p.skh, p.skt, BK);
  if (!err) err = make_map_bf16_4d(&tv, p.v, p.B, p.Hkv, p.T, d, p.svb, p.svh, p.svt, BK);
  if (err) return static_cast<cudaError_t>(err);
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_wide_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)p.B * p.H * nt * ng;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  flash_fwd_wide_kernel<<<(unsigned)blocks, WG_NT, bytes, stream>>>(tq, tk, tv, p, d);
  return recorded(cudaGetLastError(), "column_groups", WG_NT);
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const int* mask,
                                   void* out, float* lse, int B, int H, int Hkv, int T, int d,
                                   long long sqb, long long sqh, long long sqt, long long skb,
                                   long long skh, long long skt, long long svb, long long svh,
                                   long long svt, int causal, int is_bf16, float scale,
                                   void* stream) {
  const Params p{q,   k,   v,   mask, out, lse, B,   H,   Hkv,    T,    sqb,
                 sqh, sqt, skb, skh,  skt, svb, svh, svt, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d > 256 && d % 64 == 0) {
    if (is_bf16 && d <= FWD_SPLIT_MAX_D) return launch_split(p, d, st);
    return launch_wide(p, d, is_bf16, st);
  }
  if (is_bf16) {
    if (d == 128) return launch_wgmma<128>(p, st);
    if (d == 64) return launch_wgmma<64>(p, st);
    if (d == 256) return launch_wgmma<256>(p, st);
  } else {
    if (d == 128) return launch(flash_fwd_f32_kernel<128>, NT, f32_smem_bytes<128>(), p, st);
    if (d == 64) return launch(flash_fwd_f32_kernel<64>, NT, f32_smem_bytes<64>(), p, st);
    if (d == 256) return launch(flash_fwd_f32_kernel<256>, NT, f32_smem_bytes<256>(), p, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The last accepted launch of flash_attention_fwd in this process, as its
// launcher configured it: the kind of kernel ("wgmma", "f32", "fwd_split",
// "column_groups", "column_groups_f32"; "none" before the first) and the
// threads a block.
extern "C" int flash_attention_fwd_last_launch(const char** kind, int* threads) {
  *kind = g_last.kind;
  *threads = g_last.threads;
  return 0;
}
