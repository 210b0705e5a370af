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
//
// What bounds it on the H100. The work is 4*T^2*d multiply-adds per (b, h),
// halved by the causal skip; the bytes are q, k, v, out once. At the GRPO
// scoring shapes (T ~ 320, d = 128) that is about 100 operations per byte:
// under the bf16 tensor-core ridge (~295), so the card's bound is memory. The
// bf16 kernel's own limits are the short kv loop at small T (a q tile meets
// at most T / 64 kv tiles, so the ring barely fills and each block pays its
// setup, Q load and first K/V load in full) and, at long T, latency: two
// 64-row warpgroups an SM (registers allow no third) and 64 x 64 score
// tiles leave the tensor cores idle between dependent steps. PERF.md holds
// its time beside the bound.

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

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, int bytes, const Params& p, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + BQ - 1) / BQ, p.B * p.H);
  kernel<<<grid, threads, bytes, stream>>>(p);
  return cudaGetLastError();
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
  return cudaGetLastError();
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
