// Fused lm-head + log-softmax forward for Hopper, sm_90a, on the tensor cores.
//
// Replaces the TPU kernel agilerl_tpu/ops/fused_loss.py:_make_kernel
// (pallas_call in _fwd_call).
//
// What it computes, per row n of hidden [N, D] (f32) against head [D, V] (f32):
//   z_v    = (hidden_n . head_:,v) * inv_temp        (vocab columns >= V masked)
//   lse_n  = log sum_v exp(z_v)      out_n = z_target_n - lse_n
// without ever writing the [N, V] logits: an online (max, sum-exp, chosen)
// triple per row, as in the TPU kernel. The products run in 3xTF32 on wgmma
// (tf32x3_gemm.cuh): hi*hi + hi*lo + lo*hi with f32 accumulators, which
// agrees with an f32 product to f32 summation order.
//
// Operands. wgmma takes tf32 operands K-major only, so the kernel reads the
// hidden states split into hi/lo [N, D] and the head transposed and split,
// hi/lo [V, D]; tf32x3_split makes both once per call (the wrapper,
// ops/fused_loss.py, allocates them: 2 x 4 * V * D bytes, 4.2 GB at
// llama3-8b, for the length of the call).
//
// Translation. The TPU grid (row block, vocab block) runs the vocab axis in
// order and carries (m, s, c) in VMEM scratch. On the card the blocks run in
// parallel, so block (row tile, vocab tile) folds its 128 x 128 logits into
// one partial (max, sum-exp, chosen) triple per row: each thread over its 32
// columns of two rows, then the four threads of a quad with shuffles. A
// second kernel merges the vocab tiles' partial triples, one warp per row.
// One block of 288 threads (192 KB of shared memory) per SM. Each block takes
// one vocab tile: blocks that each walked a split of the vocab sized to whole
// waves (the SIMT kernel's scheme) ran slower on the H100 at the learn
// shapes, as far as we can tell because long-lived blocks drift apart and
// stop sharing their reads in L2 (PERF.md).
//
// Head traffic. Blocks are numbered row tile fastest, so the 40 row tiles of
// one vocab tile run side by side and read the same head tile at about the
// same time: those repeat reads hit the 50 MB L2. Per output tile the block
// reads 8 bytes (hi + lo) per element of its 128 hidden rows and its 128
// head rows over D: 8 MB per tile at D = 4096, from L2.
//
// What bounds it on the H100: 2*N*D*V f32 operations (5.36 TFLOP at the
// learn shapes) are 3 x that in TF32 tensor-core work: 32.5 ms at 495
// TFLOP/s (80.0 ms at the 67 TFLOP/s of f32 outside the tensor cores). The
// bytes (the head once, 2.1 GB) take 0.6 ms. PERF.md holds the time beside
// the bound.

#include "tf32x3_gemm.cuh"

namespace {

constexpr float NEG = -1e30f;

// Partial (max, sum-exp, chosen) per row over one 128-column vocab tile;
// grid (row tiles, vocab tiles).
__global__ void __launch_bounds__(tc::NTHREADS, 1)
    logprob_partial(const __grid_constant__ CUtensorMap a_hi,
                    const __grid_constant__ CUtensorMap a_lo,
                    const __grid_constant__ CUtensorMap b_hi,
                    const __grid_constant__ CUtensorMap b_lo, const int* __restrict__ tgt,
                    float* __restrict__ part_m, float* __restrict__ part_s,
                    float* __restrict__ part_c, int N, int D, int V, float inv_temp) {
  extern __shared__ uint8_t smem[];
  const tc::Ring ring = tc::ring_setup(smem);
  const int m0 = blockIdx.x * tc::BM;
  const int vt = blockIdx.y;
  const int nk = (D + tc::BK - 1) / tc::BK;
  tc::Pipe pipe;

  if (threadIdx.x >= tc::NCONSUMER) {  // producer warp
    if (threadIdx.x == tc::NCONSUMER)
      tc::load_tile(tc::Maps{&a_hi, &a_lo, &b_hi, &b_lo}, ring, pipe, m0, vt * tc::BN, 0, 0, nk);
    return;
  }

  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  float acc[tc::NACC];
  tc::mma_tile(acc, ring, pipe, nk, wg);
  const int n0 = vt * tc::BN + (lane & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2) + 8 * h;
    const int t = row < N ? tgt[row] : -1;
    float m = NEG, c = 0.f;
#pragma unroll
    for (int g = 0; g < tc::BN / 8; ++g)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + g * 8 + e;
        const float z = acc[g * 4 + h * 2 + e] * inv_temp;
        if (col < V) {
          m = fmaxf(m, z);
          if (col == t) c += z;
        }
      }
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < tc::BN / 8; ++g)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (n0 + g * 8 + e < V) s += expf(acc[g * 4 + h * 2 + e] * inv_temp - m);
    // the four threads of a quad hold the same row
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m, off);
      const float so = __shfl_xor_sync(0xffffffffu, s, off);
      const float mn = fmaxf(m, mo);
      s = s * expf(m - mn) + so * expf(mo - mn);
      m = mn;
      c += __shfl_xor_sync(0xffffffffu, c, off);
    }
    if ((lane & 3) == 0 && row < N) {
      const long long at = (long long)vt * N + row;
      part_m[at] = m;
      part_s[at] = s;
      part_c[at] = c;
    }
  }
}

// lse and logprob per row from the n_tiles partial triples; one warp per row.
__global__ void fused_logprob_merge(const float* __restrict__ part_m,
                                    const float* __restrict__ part_s,
                                    const float* __restrict__ part_c, float* __restrict__ out,
                                    float* __restrict__ lse, int N, int n_tiles) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;
  float m = NEG, s = 0.f, c = 0.f;
  for (int k = lane; k < n_tiles; k += 32) {
    const long long at = (long long)k * N + row;
    const float mk = part_m[at];
    const float mn = fmaxf(m, mk);
    s = s * expf(m - mn) + part_s[at] * expf(mk - mn);
    m = mn;
    c += part_c[at];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float so = __shfl_xor_sync(0xffffffffu, s, off);
    const float mn = fmaxf(m, mo);
    s = s * expf(m - mn) + so * expf(mo - mn);
    m = mn;
    c += __shfl_xor_sync(0xffffffffu, c, off);
  }
  if (lane == 0) {
    const float l = m + logf(s);
    lse[row] = l;
    out[row] = c - l;
  }
}

int launch_fwd(const float* hid_hi, const float* hid_lo, const float* wt_hi, const float* wt_lo,
               const int* targets, float* out, float* lse, float* scratch, int N, int D, int V,
               float inv_temp, cudaStream_t st) {
  CUtensorMap a_hi, a_lo, b_hi, b_lo;
  int err = tc::make_map(&a_hi, hid_hi, D, N, D, tc::BM);
  if (!err) err = tc::make_map(&a_lo, hid_lo, D, N, D, tc::BM);
  if (!err) err = tc::make_map(&b_hi, wt_hi, D, V, D, tc::BN);
  if (!err) err = tc::make_map(&b_lo, wt_lo, D, V, D, tc::BN);
  if (err) return err;
  const int n_tiles = (V + tc::BN - 1) / tc::BN;
  if (n_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  float* pm = scratch;
  float* ps = scratch + (long long)n_tiles * N;
  float* pc = scratch + 2LL * n_tiles * N;
  cudaError_t e = cudaFuncSetAttribute(logprob_partial,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, tc::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + tc::BM - 1) / tc::BM, n_tiles);
  logprob_partial<<<grid, tc::NTHREADS, tc::SMEM, st>>>(a_hi, a_lo, b_hi, b_lo, targets, pm, ps,
                                                        pc, N, D, V, inv_temp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_logprob_merge<<<(N + 7) / 8, 256, 0, st>>>(pm, ps, pc, out, lse, N, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// hi, lo [rows, ld_dst] from src [rows, cols] (row stride cols); columns
// cols..ld_dst are written as 0.
__global__ void split_rows(const float* __restrict__ src, float* __restrict__ hi,
                           float* __restrict__ lo, long long rows, int cols, int ld_dst) {
  const long long n = rows * ld_dst;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / ld_dst;
    const int c = static_cast<int>(i - r * ld_dst);
    const float x = c < cols ? src[r * cols + c] : 0.f;
    const float h = tc::rna_tf32(x);
    hi[i] = h;
    lo[i] = tc::rna_tf32(x - h);
  }
}

// hi, lo [cols, ld] from src [rows, cols]: 32 x 32 tiles through shared
// memory, so that both the reads and the writes are coalesced; columns
// rows..ld are written as 0.
__global__ void split_transpose(const float* __restrict__ src, float* __restrict__ hi,
                                float* __restrict__ lo, int rows, int cols, int ld) {
  __shared__ float t[32][33];
  const int c0 = blockIdx.x * 32;
  const int r0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int r = r0 + i, c = c0 + threadIdx.x;
    t[i][threadIdx.x] = (r < rows && c < cols) ? src[(long long)r * cols + c] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int c = c0 + i, r = r0 + threadIdx.x;
    if (c < cols && r < ld) {
      const float x = t[threadIdx.x][i];
      const float h = tc::rna_tf32(x);
      const long long at = (long long)c * ld + r;
      hi[at] = h;
      lo[at] = tc::rna_tf32(x - h);
    }
  }
}

}  // namespace

// The operand preparation of the 3xTF32 kernels (fwd and bwd): hi/lo of
// src [rows, cols]; transpose == 0: [rows, ld_dst], ld_dst >= cols, else
// [cols, ld_dst], ld_dst >= rows; the columns past the source's are 0.
// Returns a cudaError_t.
extern "C" int tf32x3_split(const float* src, float* hi, float* lo, int rows, int cols,
                            int ld_dst, int transpose, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || cols <= 0) return 0;
  if (ld_dst < (transpose ? rows : cols)) return static_cast<int>(cudaErrorInvalidValue);
  if (transpose) {
    if ((ld_dst + 31) / 32 > 65535) return static_cast<int>(cudaErrorInvalidValue);
    split_transpose<<<dim3((cols + 31) / 32, (ld_dst + 31) / 32), dim3(32, 8), 0, st>>>(
        src, hi, lo, rows, cols, ld_dst);
  } else {
    const long long blocks = ((long long)rows * ld_dst + 255) / 256;
    split_rows<<<static_cast<unsigned>(blocks < (1 << 30) ? blocks : (1 << 30)), 256, 0, st>>>(
        src, hi, lo, rows, cols, ld_dst);
  }
  return static_cast<int>(cudaGetLastError());
}

// hidden hi/lo [N, D], head^T hi/lo [V, D] (from tf32x3_split); scratch:
// 3 * ceil(V / 128) * N floats. Returns a cudaError_t: 0 when both launches
// were accepted.
extern "C" int fused_logprob_fwd(const float* hid_hi, const float* hid_lo, const float* wt_hi,
                                 const float* wt_lo, const int* targets, float* out, float* lse,
                                 float* scratch, int N, int D, int V, float inv_temp,
                                 void* stream) {
  if (D % 8 != 0 || D <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  return launch_fwd(hid_hi, hid_lo, wt_hi, wt_lo, targets, out, lse, scratch, N, D, V, inv_temp,
                    static_cast<cudaStream_t>(stream));
}
