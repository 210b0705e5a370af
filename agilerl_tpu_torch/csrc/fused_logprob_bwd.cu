// Fused lm-head + log-softmax backward (dH and dW) for Hopper, sm_90a, on the
// tensor cores.
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
// Both run in 3xTF32 on wgmma (tf32x3_gemm.cuh), from operands split into
// hi/lo by tf32x3_split (csrc/fused_logprob_fwd.cu) once per call. wgmma
// takes tf32 operands K-major only, so every product reads operands whose
// rows run along its contraction:
// - the coefficient (the logits again, as the forward computes them):
//   hidden [N, D] and head^T [V, D], K = D;
// - dH = coef head^T: the coefficient [N, chunk] and head [D, V] itself, row
//   stride padded to 4 floats for TMA, K = the chunk's vocab columns;
// - dW = hidden^T coef: hidden^T [D, ldN] and coef^T [chunk, ldN], K = N
//   (ldN: N padded to 4 floats for TMA; TMA reads no column past N).
// Per chunk of `chunk` vocab columns, coef_tc writes the chunk's coefficient
// times inv_temp, split into hi/lo, as [N, chunk] for dH or transposed, as
// [chunk, ldN], for dW (a warp's store then covers 8 consecutive rows of 4
// columns: four whole 32-byte segments). product_tc then
// - adds coef_chunk head_chunk^T into dH [N, D] (the first chunk writes, the
//   later ones add, in launch order), or
// - writes hidden^T coef_chunk into the chunk's columns of dW [D, V]: each
//   element once, since the whole of K = N is in one block.
// The split operands take 2 x 4 * V * D bytes for head^T (4.2 GB at
// llama3-8b) and as much again for head (dH), 2 x 4 * D * ldN for hidden^T
// (167 MB at the learn shapes, dW), for the length of the call; coef^T of
// one chunk 2 x 4 * chunk * ldN (334 MB).
//
// What bounds them on the H100: each of dH and dW is 4*N*D*V f32 operations
// (the logits again, then the product), 10.7 TFLOP at the learn shapes, done
// as 3 x that in TF32 on the tensor cores: 65.0 ms at 495 TFLOP/s (160 ms
// on f32 FMAs). The bytes (hidden, head, one output) are about 2.3 GB,
// 0.7 ms. PERF.md holds their times beside the bounds.

#include "tf32x3_gemm.cuh"

namespace {

// coef * inv_temp for vocab columns v0 + c of the chunk, split into hi/lo:
// at [row, c] (row stride ld) or, TRANSPOSED, at [c, row] (row stride ld), in
// 3xTF32; grid (row tiles, chunk columns / tc::BN).
template <bool TRANSPOSED>
__global__ void __launch_bounds__(tc::NTHREADS, 1)
    coef_tc(const __grid_constant__ CUtensorMap a_hi, const __grid_constant__ CUtensorMap a_lo,
            const __grid_constant__ CUtensorMap b_hi, const __grid_constant__ CUtensorMap b_lo,
            const int* __restrict__ tgt, const float* __restrict__ lse,
            const float* __restrict__ g, float* __restrict__ coef_hi,
            float* __restrict__ coef_lo, long long ld, int N, int D, int V, int v0,
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
      if (TRANSPOSED) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long long at = (long long)(c + e) * ld + row;
          coef_hi[at] = hv[e];
          coef_lo[at] = lv[e];
        }
      } else {
        const long long at = (long long)row * ld + c;
        *reinterpret_cast<float2*>(coef_hi + at) = make_float2(hv[0], hv[1]);
        *reinterpret_cast<float2*>(coef_lo + at) = make_float2(lv[0], lv[1]);
      }
    }
  }
}

// out[m, n] (+)= sum_k A[m, k] B[n, b_k0 + k] over k < klen, in 3xTF32, for
// m < M and n < ncols (out's row stride ld); grid (M / tc::BM, ncols / tc::BN).
__global__ void __launch_bounds__(tc::NTHREADS, 1)
    product_tc(const __grid_constant__ CUtensorMap a_hi, const __grid_constant__ CUtensorMap a_lo,
               const __grid_constant__ CUtensorMap b_hi, const __grid_constant__ CUtensorMap b_lo,
               float* __restrict__ out, long long ld, int M, int ncols, int b_k0, int klen,
               int accumulate) {
  extern __shared__ uint8_t smem[];
  const tc::Ring ring = tc::ring_setup(smem);
  const int m0 = blockIdx.x * tc::BM;
  const int n0 = blockIdx.y * tc::BN;
  const int nk = (klen + tc::BK - 1) / tc::BK;
  tc::Pipe pipe;
  if (threadIdx.x >= tc::NCONSUMER) {
    if (threadIdx.x == tc::NCONSUMER)
      tc::load_tile(tc::Maps{&a_hi, &a_lo, &b_hi, &b_lo}, ring, pipe, m0, n0, 0, b_k0, nk);
    return;
  }
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  float acc[tc::NACC];
  tc::mma_tile(acc, ring, pipe, nk, wg);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2) + 8 * h;
    if (row >= M) continue;
    float* dst = out + (long long)row * ld;
#pragma unroll
    for (int j = 0; j < tc::BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + j * 8 + (lane & 3) * 2 + e;
        if (col < ncols) {
          const float x = acc[j * 4 + h * 2 + e];
          dst[col] = accumulate ? dst[col] + x : x;
        }
      }
    }
  }
}

cudaError_t set_smem() {
  cudaError_t e =
      cudaFuncSetAttribute(coef_tc<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(coef_tc<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(product_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::SMEM);
  return e;
}

struct Split {  // the hi/lo parts of one operand and its maps
  CUtensorMap hi, lo;
};

int make_split(Split& s, const float* hi, const float* lo, long long inner, long long outer,
               long long ld, int box_outer) {
  int err = tc::make_map(&s.hi, hi, inner, outer, ld, box_outer);
  return err ? err : tc::make_map(&s.lo, lo, inner, outer, ld, box_outer);
}

// One backward: per vocab chunk, the coefficient pass, then the product.
// DW: the coefficient is written transposed ([chunk, ld3]) and the product is
// hidden^T (third operand: hidden^T hi/lo [D, ld3]) times it into dW [D, V];
// else it is [N, chunk] and the product is it times head^T (third operand:
// head hi/lo [D, ld3]) into dH [N, D].
template <bool DW>
int launch_bwd(const float* hid_hi, const float* hid_lo, const float* wt_hi, const float* wt_lo,
               const float* x_hi, const float* x_lo, int ld3, const int* targets,
               const float* lse, const float* g, float* out, float* coef_hi, float* coef_lo,
               int N, int D, int V, int chunk, float inv_temp, cudaStream_t st) {
  Split hid, head_t, third, coef;
  int err = make_split(hid, hid_hi, hid_lo, D, N, D, tc::BM);
  if (!err) err = make_split(head_t, wt_hi, wt_lo, D, V, D, tc::BN);
  if (DW) {
    if (!err) err = make_split(third, x_hi, x_lo, N, D, ld3, tc::BM);
    if (!err) err = make_split(coef, coef_hi, coef_lo, N, chunk, ld3, tc::BN);
  } else {
    if (!err) err = make_split(coef, coef_hi, coef_lo, chunk, N, chunk, tc::BM);
    if (!err) err = make_split(third, x_hi, x_lo, V, D, ld3, tc::BN);
  }
  if (err) return err;
  cudaError_t e = set_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int row_tiles = (N + tc::BM - 1) / tc::BM;
  for (int v0 = 0; v0 < V; v0 += chunk) {
    const int klen = min(chunk, V - v0);
    const int col_tiles = (klen + tc::BN - 1) / tc::BN;
    coef_tc<DW><<<dim3(row_tiles, col_tiles), tc::NTHREADS, tc::SMEM, st>>>(
        hid.hi, hid.lo, head_t.hi, head_t.lo, targets, lse, g, coef_hi, coef_lo,
        DW ? ld3 : chunk, N, D, V, v0, inv_temp);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    if (DW)  // dW[:, v0 + c] = sum_n hidden^T[:, n] coef^T[c, n], written once
      product_tc<<<dim3((D + tc::BM - 1) / tc::BM, col_tiles), tc::NTHREADS, tc::SMEM, st>>>(
          third.hi, third.lo, coef.hi, coef.lo, out + v0, V, D, klen, 0, N, 0);
    else  // dH (+)= coef_chunk head[:, v0 .. v0 + klen)^T
      product_tc<<<dim3(row_tiles, (D + tc::BN - 1) / tc::BN), tc::NTHREADS, tc::SMEM, st>>>(
          coef.hi, coef.lo, third.hi, third.lo, out, D, N, D, v0, klen, v0 > 0);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

int check_args(int N, int D, int V, int chunk, int ld3, int ld3_min) {
  if (D % 8 != 0 || D <= 0 || V <= 0 || N < 0 || chunk % tc::BN != 0 || ld3 < ld3_min)
    return static_cast<int>(cudaErrorInvalidValue);
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
  if (int err = check_args(N, D, V, chunk, ld_w, V)) return err;
  if (N == 0) return 0;
  return launch_bwd<false>(hid_hi, hid_lo, wt_hi, wt_lo, w_hi, w_lo, ld_w, targets, lse, g, dh,
                           coef_hi, coef_lo, N, D, V, chunk, inv_temp,
                           static_cast<cudaStream_t>(stream));
}

// dW [D, V] in 3xTF32. hidden hi/lo [N, D], head^T hi/lo [V, D] and
// hidden^T hi/lo [D, ld_n] (ld_n >= N, a multiple of 4) come from
// tf32x3_split; coef_hi/lo: chunk * ld_n floats each; chunk a multiple of
// 128. Returns a cudaError_t: 0 when every launch was accepted.
extern "C" int fused_logprob_dw(const float* hid_hi, const float* hid_lo, const float* wt_hi,
                                const float* wt_lo, const float* ht_hi, const float* ht_lo,
                                int ld_n, const int* targets, const float* lse, const float* g,
                                float* dw, float* coef_hi, float* coef_lo, int N, int D, int V,
                                int chunk, float inv_temp, void* stream) {
  if (int err = check_args(N, D, V, chunk, ld_n, N)) return err;
  if (N == 0) return 0;
  return launch_bwd<true>(hid_hi, hid_lo, wt_hi, wt_lo, ht_hi, ht_lo, ld_n, targets, lse, g, dw,
                          coef_hi, coef_lo, N, D, V, chunk, inv_temp,
                          static_cast<cudaStream_t>(stream));
}
