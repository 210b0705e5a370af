// Fused lm-head + log-softmax backward (dH and dW) for Hopper, sm_90a.
//
// Replaces the TPU kernels agilerl_tpu/ops/fused_loss.py:_make_dh_kernel
// (pallas_call in _diff_bwd, the dh call) and :_make_dw_kernel (the dw call),
// with the coefficient of :_bwd_coef.
//
// What they compute, from hidden [N, D] and head [D, V] (f32), targets [N],
// the forward's lse [N] and the upstream gradient g [N]:
//   z_nv    = (hidden_n . head_:,v) * inv_temp
//   coef_nv = v < V ? g_n * ([v == t_n] - exp(z_nv - lse_n)) : 0
//   dH      = coef head^T * inv_temp           dW = hidden^T coef * inv_temp
//
// Translation. The TPU kernels keep an f32 accumulator of [BN, D] (dH) or
// [D, BV] (dW) in VMEM and recompute the logits of a tile inside the same
// grid step. At D = 4096 that accumulator is 2 MB, and a Hopper block has at
// most 227 KB of shared memory. So the coefficient is staged through device
// memory one vocab chunk at a time (at the GRPO learn shapes a chunk of 8192
// columns is 167 MB; the whole coefficient would be 2.6 GB). No atomics
// anywhere, so both results are deterministic (as the TPU kernels' two-kernel
// split is). The vocab tail is masked in the coefficient, which is 0 there.
//
// dH runs on the tensor cores in 3xTF32 (tf32x3_gemm.cuh), from operands
// split into hi/lo by tf32x3_split (csrc/fused_logprob_fwd.cu) once per call:
// hidden [N, D], head^T [V, D] for the logits, and head [D, V] itself, whose
// rows are already K-major for coef head^T (row stride padded to 4 floats for
// TMA). Per chunk of `chunk` columns:
// - coef_tc recomputes the chunk's logits as the forward does and writes
//   coef * inv_temp split into hi/lo [N, chunk];
// - dh_tc adds coef_chunk head_chunk^T into dH [N, D] (the first chunk
//   writes, the later ones add, in launch order).
// The split operands take 2 x 4 * V * D bytes for each head layout (8.4 GB at
// llama3-8b) for the length of the call.
//
// dW keeps the SIMT path: coef_chunk computes the chunk's coefficient with a
// 128 x 128 x 8 register-tiled f32 GEMM main loop (256 threads, 8 x 8
// outputs each, double-buffered shared-memory stages filled through
// registers as float4s), and dw_chunk writes hidden^T coef_chunk into the
// chunk's columns of dW [D, V], each operand read along K (staged transposed)
// or along M/N. Under tf32 both of dW's operands would be MN-major, which
// wgmma does not take (ROADMAP, Queue 2).
//
// What bounds them on the H100: each of dH and dW is 4*N*D*V f32 operations
// (the logits again, then the product), 10.7 TFLOP at the learn shapes. dH on
// the tensor cores does 3 x that in TF32: 65.0 ms at 495 TFLOP/s; dW on f32
// FMAs: 160 ms at 67 TFLOP/s. The bytes (hidden, head, one output) are about
// 2.3 GB, 0.7 ms. PERF.md holds their times beside the bounds.

#include "tf32x3_gemm.cuh"

namespace {

constexpr int BM = 128;  // output rows per block
constexpr int BN = 128;  // output columns per block
constexpr int BK = 8;    // depth of one shared-memory stage
constexpr int PAD = 4;   // keeps float4 alignment, spreads the transposed stores over banks
constexpr int NT = 256;  // 16 x 16 threads

// One GEMM operand: element (m, k) at p[m * ld + k] when read along K
// (KCONTIG), else at p[k * ld + m]. m < m_lim and k < k_lim hold data; the
// rest reads as 0. VEC: the contiguous dimension's limit and ld are
// multiples of 4 and p is 16-byte aligned, so a float4 is wholly in or out.
struct Operand {
  const float* p;
  long long ld;
  int m_lim;
  int k_lim;
};

template <bool KCONTIG, bool VEC>
__device__ __forceinline__ float4 fetch(const Operand& o, int m0, int kt, int tid) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  int m, k;
  if (KCONTIG) {  // 128 rows x 8 k: two float4s per row
    m = m0 + (tid >> 1);
    k = kt * BK + (tid & 1) * 4;
    if (m >= o.m_lim) return zero;
    const float* src = o.p + (long long)m * o.ld + k;
    if (VEC) return k < o.k_lim ? *reinterpret_cast<const float4*>(src) : zero;
    return make_float4(k < o.k_lim ? src[0] : 0.f, k + 1 < o.k_lim ? src[1] : 0.f,
                       k + 2 < o.k_lim ? src[2] : 0.f, k + 3 < o.k_lim ? src[3] : 0.f);
  }
  // 8 k x 128 columns: 32 float4s per k row
  k = kt * BK + (tid >> 5);
  m = m0 + (tid & 31) * 4;
  if (k >= o.k_lim) return zero;
  const float* src = o.p + (long long)k * o.ld + m;
  if (VEC) return m < o.m_lim ? *reinterpret_cast<const float4*>(src) : zero;
  return make_float4(m < o.m_lim ? src[0] : 0.f, m + 1 < o.m_lim ? src[1] : 0.f,
                     m + 2 < o.m_lim ? src[2] : 0.f, m + 3 < o.m_lim ? src[3] : 0.f);
}

template <bool KCONTIG>
__device__ __forceinline__ void stage(float (*S)[BM + PAD], float4 x, int tid) {
  if (KCONTIG) {
    const int m = tid >> 1, k = (tid & 1) * 4;
    S[k + 0][m] = x.x;
    S[k + 1][m] = x.y;
    S[k + 2][m] = x.z;
    S[k + 3][m] = x.w;
  } else {
    *reinterpret_cast<float4*>(&S[tid >> 5][(tid & 31) * 4]) = x;
  }
}

// the thread's 8 rows / columns of the 128 x 128 tile
__device__ __forceinline__ int row_of(int ty, int i) { return ty * 4 + (i & 3) + (i >> 2) * 64; }
__device__ __forceinline__ int col_of(int tx, int j) { return tx * 4 + (j & 3) + (j >> 2) * 64; }

struct Stages {
  float a[2][BK][BM + PAD];
  float b[2][BK][BN + PAD];
};

// acc[i][j] = sum_k A(m0 + row_of(i), k) * B(n0 + col_of(j), k) over nk stages
template <bool KA, bool VA, bool KB, bool VB>
__device__ __forceinline__ void gemm_tile(float (&acc)[8][8], const Operand& A, int m0,
                                          const Operand& B, int n0, int nk, Stages& sm) {
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  stage<KA>(sm.a[0], fetch<KA, VA>(A, m0, 0, tid), tid);
  stage<KB>(sm.b[0], fetch<KB, VB>(B, n0, 0, tid), tid);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    float4 ra, rb;
    if (more) {  // fetch the next stage while this one is multiplied
      ra = fetch<KA, VA>(A, m0, kt + 1, tid);
      rb = fetch<KB, VB>(B, n0, kt + 1, tid);
    }
#pragma unroll
    for (int kd = 0; kd < BK; ++kd) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.a[cur][kd][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sm.a[cur][kd][ty * 4 + 64]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sm.b[cur][kd][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sm.b[cur][kd][tx * 4 + 64]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    if (more) {  // the other stage was last read before the previous barrier
      stage<KA>(sm.a[cur ^ 1], ra, tid);
      stage<KB>(sm.b[cur ^ 1], rb, tid);
    }
    __syncthreads();
  }
}

// coef[n, c] for vocab columns v0 + c of the chunk, c < chunk, times inv_temp.
// grid (row tiles, chunk / 128)
template <bool VEC_HEAD>
__global__ void __launch_bounds__(NT, 2)
    coef_chunk(const float* __restrict__ hid, const float* __restrict__ head,
               const int* __restrict__ tgt, const float* __restrict__ lse,
               const float* __restrict__ g, float* __restrict__ coef, int N, int D, int V, int v0,
               int chunk, float inv_temp) {
  __shared__ __align__(16) Stages sm;
  const Operand A{hid, D, N, D};           // hidden, read along D
  const Operand B{head, V, V, D};          // head, read along V
  const int m0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * BN;          // column in the chunk
  float acc[8][8];
  gemm_tile<true, true, false, VEC_HEAD>(acc, A, m0, B, v0 + c0, D / BK, sm);

  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + row_of(ty, i);
    if (row >= N) continue;
    const int t = tgt[row];
    const float l = lse[row];
    const float gs = g[row] * inv_temp;
    float c[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = v0 + c0 + col_of(tx, j);
      const float pr = expf(acc[i][j] * inv_temp - l);
      c[j] = col < V ? gs * ((col == t ? 1.f : 0.f) - pr) : 0.f;
    }
    float* dst = coef + (long long)row * chunk + c0 + tx * 4;
    *reinterpret_cast<float4*>(dst) = make_float4(c[0], c[1], c[2], c[3]);
    *reinterpret_cast<float4*>(dst + 64) = make_float4(c[4], c[5], c[6], c[7]);
  }
}

// dW[d, v0 + c] = sum_n hidden[n, d] coef[n, c]; grid (D tiles, chunk / 128)
__global__ void __launch_bounds__(NT, 2)
    dw_chunk(const float* __restrict__ hid, const float* __restrict__ coef,
             float* __restrict__ dw, int N, int D, int V, int v0, int chunk) {
  __shared__ __align__(16) Stages sm;
  const Operand A{hid, D, D, N};       // hidden^T: rows are d, read along d
  const Operand B{coef, chunk, chunk, N};  // coef: columns, read along the chunk
  const int m0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * BN;
  float acc[8][8];
  gemm_tile<false, true, false, true>(acc, A, m0, B, c0, (N + BK - 1) / BK, sm);

  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + row_of(ty, i);
    if (row >= D) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = v0 + c0 + col_of(tx, j);
      if (col < V) dw[(long long)row * V + col] = acc[i][j];
    }
  }
}

cudaError_t launch_coef(const float* hidden, const float* head, const int* targets,
                        const float* lse, const float* g, float* coef, int N, int D, int V,
                        int v0, int chunk, float inv_temp, cudaStream_t st) {
  const dim3 grid((N + BM - 1) / BM, chunk / BN);
  if (V % 4 == 0) {
    coef_chunk<true><<<grid, NT, 0, st>>>(hidden, head, targets, lse, g, coef, N, D, V, v0,
                                           chunk, inv_temp);
  } else {
    coef_chunk<false><<<grid, NT, 0, st>>>(hidden, head, targets, lse, g, coef, N, D, V, v0,
                                            chunk, inv_temp);
  }
  return cudaGetLastError();
}

// coef * inv_temp for vocab columns v0 + c, c < chunk, as hi/lo [N, chunk]
// in 3xTF32; grid (row tiles, chunk columns / tc::BN).
__global__ void __launch_bounds__(tc::NTHREADS, 1)
    coef_tc(const __grid_constant__ CUtensorMap a_hi, const __grid_constant__ CUtensorMap a_lo,
            const __grid_constant__ CUtensorMap b_hi, const __grid_constant__ CUtensorMap b_lo,
            const int* __restrict__ tgt, const float* __restrict__ lse,
            const float* __restrict__ g, float* __restrict__ coef_hi,
            float* __restrict__ coef_lo, int N, int D, int V, int v0, int chunk,
            float inv_temp) {
  extern __shared__ uint8_t smem[];
  const tc::Ring ring = tc::ring_setup(smem);
  const int m0 = blockIdx.x * tc::BM;
  const int c0 = blockIdx.y * tc::BN;  // column in the chunk
  const int nk = (D + tc::BK - 1) / tc::BK;
  tc::Pipe pipe;
  if (threadIdx.x >= tc::NCONSUMER) {
    if (threadIdx.x == tc::NCONSUMER)
      tc::load_tile(tc::Maps{&a_hi, &a_lo, &b_hi, &b_lo}, ring, pipe, m0, v0 + c0, 0, 0, nk);
    return;
  }
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  float acc[tc::NACC];
  tc::mma_tile(acc, ring, pipe, nk, wg);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2) + 8 * h;
    if (row >= N) continue;
    const int t = tgt[row];
    const float l = lse[row];
    const float gs = g[row] * inv_temp;
#pragma unroll
    for (int j = 0; j < tc::BN / 8; ++j) {
      const int c = c0 + j * 8 + (lane & 3) * 2;
      float hv[2], lv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = v0 + c + e;
        const float p = expf(acc[j * 4 + h * 2 + e] * inv_temp - l);
        const float x = col < V ? gs * ((col == t ? 1.f : 0.f) - p) : 0.f;
        hv[e] = tc::rna_tf32(x);
        lv[e] = tc::rna_tf32(x - hv[e]);
      }
      const long long at = (long long)row * chunk + c;
      *reinterpret_cast<float2*>(coef_hi + at) = make_float2(hv[0], hv[1]);
      *reinterpret_cast<float2*>(coef_lo + at) = make_float2(lv[0], lv[1]);
    }
  }
}

// dH[n, d] (+)= sum_c coef[n, c] head[d, v0 + c] over c < klen, in 3xTF32;
// grid (row tiles, D / tc::BN).
__global__ void __launch_bounds__(tc::NTHREADS, 1)
    dh_tc(const __grid_constant__ CUtensorMap a_hi, const __grid_constant__ CUtensorMap a_lo,
          const __grid_constant__ CUtensorMap b_hi, const __grid_constant__ CUtensorMap b_lo,
          float* __restrict__ dh, int N, int D, int v0, int klen, int accumulate) {
  extern __shared__ uint8_t smem[];
  const tc::Ring ring = tc::ring_setup(smem);
  const int m0 = blockIdx.x * tc::BM;
  const int n0 = blockIdx.y * tc::BN;
  const int nk = (klen + tc::BK - 1) / tc::BK;
  tc::Pipe pipe;
  if (threadIdx.x >= tc::NCONSUMER) {
    if (threadIdx.x == tc::NCONSUMER)
      tc::load_tile(tc::Maps{&a_hi, &a_lo, &b_hi, &b_lo}, ring, pipe, m0, n0, 0, v0, nk);
    return;
  }
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  float acc[tc::NACC];
  tc::mma_tile(acc, ring, pipe, nk, wg);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2) + 8 * h;
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < tc::BN / 8; ++j) {
      const int col = n0 + j * 8 + (lane & 3) * 2;  // D % 8 == 0: both columns or neither
      if (col < D) {
        float2* dst = reinterpret_cast<float2*>(dh + (long long)row * D + col);
        float2 v = make_float2(acc[j * 4 + h * 2], acc[j * 4 + h * 2 + 1]);
        if (accumulate) {
          const float2 o = *dst;
          v.x += o.x;
          v.y += o.y;
        }
        *dst = v;
      }
    }
  }
}

int launch_dh(const float* hid_hi, const float* hid_lo, const float* wt_hi, const float* wt_lo,
              const float* w_hi, const float* w_lo, int ld_w, const int* targets,
              const float* lse, const float* g, float* dh, float* coef_hi, float* coef_lo, int N,
              int D, int V, int chunk, float inv_temp, cudaStream_t st) {
  CUtensorMap h_hi, h_lo, t_hi, t_lo, c_hi, c_lo, w_hi_m, w_lo_m;
  int err = tc::make_map(&h_hi, hid_hi, D, N, D, tc::BM);
  if (!err) err = tc::make_map(&h_lo, hid_lo, D, N, D, tc::BM);
  if (!err) err = tc::make_map(&t_hi, wt_hi, D, V, D, tc::BN);
  if (!err) err = tc::make_map(&t_lo, wt_lo, D, V, D, tc::BN);
  if (!err) err = tc::make_map(&c_hi, coef_hi, chunk, N, chunk, tc::BM);
  if (!err) err = tc::make_map(&c_lo, coef_lo, chunk, N, chunk, tc::BM);
  if (!err) err = tc::make_map(&w_hi_m, w_hi, V, D, ld_w, tc::BN);
  if (!err) err = tc::make_map(&w_lo_m, w_lo, V, D, ld_w, tc::BN);
  if (err) return err;
  cudaError_t e =
      cudaFuncSetAttribute(coef_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dh_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int row_tiles = (N + tc::BM - 1) / tc::BM;
  for (int v0 = 0; v0 < V; v0 += chunk) {
    const int klen = min(chunk, V - v0);
    coef_tc<<<dim3(row_tiles, (klen + tc::BN - 1) / tc::BN), tc::NTHREADS, tc::SMEM, st>>>(
        h_hi, h_lo, t_hi, t_lo, targets, lse, g, coef_hi, coef_lo, N, D, V, v0, chunk, inv_temp);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    dh_tc<<<dim3(row_tiles, (D + tc::BN - 1) / tc::BN), tc::NTHREADS, tc::SMEM, st>>>(
        c_hi, c_lo, w_hi_m, w_lo_m, dh, N, D, v0, klen, v0 > 0);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

// dH [N, D] in 3xTF32. hidden hi/lo [N, D], head^T hi/lo [V, D] and head
// hi/lo [D, ld_w] come from tf32x3_split; coef_hi/lo: N * chunk floats each;
// chunk a multiple of 128. Returns a cudaError_t: 0 when every launch was
// accepted.
extern "C" int fused_logprob_dh(const float* hid_hi, const float* hid_lo, const float* wt_hi,
                                const float* wt_lo, const float* w_hi, const float* w_lo,
                                int ld_w, const int* targets, const float* lse, const float* g,
                                float* dh, float* coef_hi, float* coef_lo, int N, int D, int V,
                                int chunk, float inv_temp, void* stream) {
  if (D % 8 != 0 || D <= 0 || V <= 0 || chunk % tc::BN != 0 || ld_w < V)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  return launch_dh(hid_hi, hid_lo, wt_hi, wt_lo, w_hi, w_lo, ld_w, targets, lse, g, dh, coef_hi,
                   coef_lo, N, D, V, chunk, inv_temp, static_cast<cudaStream_t>(stream));
}

// dW [D, V] on f32 FMAs. scratch: N * chunk floats; chunk a multiple of 128;
// D a multiple of 8. Returns a cudaError_t: 0 when every launch was accepted.
extern "C" int fused_logprob_dw(const float* hidden, const float* head, const int* targets,
                                const float* lse, const float* g, float* dw, float* scratch,
                                int N, int D, int V, int chunk, float inv_temp, void* stream) {
  if (D % BK != 0 || chunk % BN != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((D + BM - 1) / BM, chunk / BN);
  for (int v0 = 0; v0 < V; v0 += chunk) {
    cudaError_t err =
        launch_coef(hidden, head, targets, lse, g, scratch, N, D, V, v0, chunk, inv_temp, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    dw_chunk<<<grid, NT, 0, st>>>(hidden, scratch, dw, N, D, V, v0, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
