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
// Here one thread block owns one (b*h, 64-row q tile) and walks the kv tiles
// in a loop; (m, l, acc) stay in registers. The TPU kernel's causal skip of
// kv blocks wholly in the future becomes the loop's bound. K and V tiles are
// staged through shared memory. GQA: the block reads KV head h / (H / Hkv) in
// place, so the caller need not repeat K/V (a repeated copy, Hkv == H, works
// too).
//
// Two kernels, chosen by the input type:
// - bf16 (the model's path): tensor cores. Each of 4 warps owns 16 query rows
//   and runs mma.sync m16n8k16 (bf16 in, f32 accumulate) for S = Q K^T and
//   for O += P V. The S accumulator fragment is laid out as the A operand of
//   the P V product, so P goes from registers to the second product without
//   touching shared memory (rounded to bf16 on the way, as the TPU kernel's
//   p.astype(v.dtype)). V is stored transposed in shared memory so that each
//   B-operand register is one 32-bit read.
// - f32: the products as f32 FMAs from shared memory (no tensor cores: TF32
//   would lose the f32 inputs' precision), 256 threads in a 16 x 16 grid.
//
// What bounds it on the H100. The work is 4*T^2*d multiply-adds per (b, h),
// halved by the causal skip; the bytes are q, k, v, out once. At the GRPO
// scoring shapes (T ~ 320, d = 128) that is about 100 operations per byte:
// under the bf16 tensor-core ridge (~295), so the card's bound is memory. The
// bf16 kernel's own limits are its per-block setup at small T (a q tile
// meets at most T / 64 kv tiles) and mma.sync instead of wgmma; TMA and wgmma
// are the next step. PERF.md holds its time beside the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // keys per kv tile
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

// ------------------------------ bf16: tensor cores ------------------------- //

constexpr int MMA_NT = 128;  // 4 warps x 16 query rows

template <int HD>
constexpr int mma_smem_bytes() {
  // Qs [BQ][HD + 8], Ks [BK][HD + 8], Vt [HD][BK + 8] bf16, then BK ints
  return (BQ * (HD + 8) + BK * (HD + 8) + HD * (BK + 8)) * 2 + BK * 4;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes (8 bf16) from global memory; the wrapper checks the alignment
__device__ __forceinline__ uint4 ld128(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <int HD>
__global__ void __launch_bounds__(MMA_NT) flash_fwd_mma_kernel(const Params p) {
  constexpr int LDQ = HD + 8;  // row pitch (bf16) of Qs/Ks: conflict-free 32-bit reads
  constexpr int LDV = BK + 8;  // row pitch of Vt
  constexpr int NS = BK / 8;   // score n-tiles per warp (8 keys each)
  constexpr int NO = HD / 8;   // output n-tiles (8 dims each)
  constexpr int C8 = HD / 8;   // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LDQ;
  __nv_bfloat16* Vt = Ks + BK * LDQ;
  int* pm = reinterpret_cast<int*>(Vt + HD * LDV);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row group
  const int tg = lane & 3;   // thread in group
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = blockIdx.x * BQ;
  const int seq = p.T;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.sqb + h * p.sqh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.skb + hk * p.skh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.svb + hk * p.svh;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int e = tid; e < BQ * C8; e += MMA_NT) {
    const int r = e / C8, c = (e % C8) * 8;
    const int row = q0 + r;
    *reinterpret_cast<uint4*>(&Qs[r * LDQ + c]) = row < seq ? ld128(qg + row * p.sqt + c) : zero;
  }

  const int r0 = warp * 16 + g;  // this thread's two query rows in the tile
  const int qrow0 = q0 + r0, qrow1 = qrow0 + 8;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  const int kv_end = p.causal ? min(seq, q0 + BQ) : seq;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done (and Qs stored)
    for (int e = tid; e < BK * C8; e += MMA_NT) {
      const int r = e / C8, c = (e % C8) * 8;
      const int key = k0 + r;
      *reinterpret_cast<uint4*>(&Ks[r * LDQ + c]) = key < seq ? ld128(kg + key * p.skt + c) : zero;
    }
    // V transposed: consecutive threads take consecutive keys, so the 16-bit
    // stores into a row of Vt are conflict-free
    for (int e = tid; e < BK * C8; e += MMA_NT) {
      const int r = e % BK, c = (e / BK) * 8;
      const int key = k0 + r;
      const uint4 raw = key < seq ? ld128(vg + key * p.svt + c) : zero;
      const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(c + i) * LDV + r] = x[i];
    }
    if (tid < BK) {
      const int key = k0 + tid;
      pm[tid] = key < seq && (p.mask == nullptr || p.mask[(long long)b * seq + key] > 0);
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int c = kk * 16 + tg * 2;
      const uint32_t a0 = ld32(&Qs[r0 * LDQ + c]);
      const uint32_t a1 = ld32(&Qs[(r0 + 8) * LDQ + c]);
      const uint32_t a2 = ld32(&Qs[r0 * LDQ + c + 8]);
      const uint32_t a3 = ld32(&Qs[(r0 + 8) * LDQ + c + 8]);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const __nv_bfloat16* kr = &Ks[(n * 8 + g) * LDQ + c];
        mma_bf16(s[n], a0, a1, a2, a3, ld32(kr), ld32(kr + 8));
      }
    }

    // mask, online softmax; s[n][0..1] belong to row qrow0, s[n][2..3] to qrow1
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + tg * 2 + (e & 1);
        const int qrow = e < 2 ? qrow0 : qrow1;
        const bool ok = pm[col] && (!p.causal || k0 + col <= qrow);
        s[n][e] = ok ? s[n][e] * p.scale : NEG;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V: the score fragments of keys 16kk..16kk+15 are the A operand
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const __nv_bfloat16* vr = &Vt[(j * 8 + g) * LDV + kk * 16 + tg * 2];
        mma_bf16(o[j], a0, a1, a2, a3, ld32(vr), ld32(vr + 8));
      }
    }
  }

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? qrow0 : qrow1;
    if (row < seq) {
      const float lc = fmaxf(l[r], 1e-30f);
      const long long base = (long long)bh * seq + row;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        *reinterpret_cast<uint32_t*>(&og[base * HD + j * 8 + tg * 2]) =
            pack_bf16(o[j][2 * r] / lc, o[j][2 * r + 1] / lc);
      }
      if (tg == 0) p.lse[base] = m[r] + logf(lc);
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
    if (d == 128) return launch(flash_fwd_mma_kernel<128>, MMA_NT, mma_smem_bytes<128>(), p, st);
    if (d == 64) return launch(flash_fwd_mma_kernel<64>, MMA_NT, mma_smem_bytes<64>(), p, st);
  } else {
    if (d == 128) return launch(flash_fwd_f32_kernel<128>, NT, f32_smem_bytes<128>(), p, st);
    if (d == 64) return launch(flash_fwd_f32_kernel<64>, NT, f32_smem_bytes<64>(), p, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
