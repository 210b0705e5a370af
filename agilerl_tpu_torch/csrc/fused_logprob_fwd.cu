// Fused lm-head + log-softmax forward for Hopper, sm_90a.
//
// Replaces the TPU kernel agilerl_tpu/ops/fused_loss.py:_make_kernel
// (pallas_call in _fwd_call).
//
// What it computes, per row n of hidden [N, D] (f32) against head [D, V] (f32):
//   z_v    = (hidden_n . head_:,v) * inv_temp        (vocab columns >= V masked)
//   lse_n  = log sum_v exp(z_v)      out_n = z_target_n - lse_n
// without ever writing the [N, V] logits: an online (max, sum-exp, chosen)
// triple per row, as in the TPU kernel. Arithmetic is f32 throughout (no
// TF32), so the kernel agrees with the CPU reference to f32 summation order.
//
// Translation. The TPU grid (row block, vocab block) runs the vocab axis in
// order and carries (m, s, c) in VMEM scratch. On the card, one row tile of
// 128 rows is far too little work for 132 SMs (the GRPO scoring pass has ~40
// row tiles), so the vocab axis is split: block (row tile, split) walks its
// share of 128-column vocab tiles in a loop and keeps (m, s, c) on chip;
// a second, tiny kernel merges the splits' partial triples per row. The
// wrapper (ops/fused_loss.py:vocab_split) picks the split count against the
// card's 2 blocks per SM so that no wave of blocks runs nearly empty. Each
// thread computes an 8 x 8 block of logits per tile (rows ty*4 + {0..3, 64..67},
// columns tx*4 + {0..3, 64..67}) with f32 FMAs from double-buffered, 8-deep
// shared-memory stages (the next stage is fetched as float4s into registers
// while the current one is multiplied), folds it into its own per-row triple,
// and the 16 threads that share a row merge their triples once at the end
// with warp shuffles. Two blocks of 256 threads fit on an SM.
//
// Row-tile height and head traffic. The head (4 * D * V bytes, 2.1 GB at
// llama3-8b) is read once per row tile: ceil(N / 128) times in all. Blocks
// are numbered row tile fastest, so the row tiles of one split run side by
// side and read the same head columns at about the same time: those repeat
// reads hit the 50 MB L2, and device memory sees the head about once.
//
// What bounds it on the H100: 2*N*D*V f32 operations (5.4 TFLOP at the
// scoring shapes) against 67 TFLOP/s of f32 outside the tensor cores, about
// 80 ms; the bytes (the head once, 2.1 GB) take about 0.6 ms. It is bound by
// operations; the kernel's own limits are FMA throughput and shared-memory reads
// (16 floats read per 64 FMAs). PERF.md holds its time beside the bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;   // rows per tile
constexpr int BV = 128;   // vocab columns per tile
constexpr int BD = 8;     // depth of one shared-memory stage
constexpr int APAD = 4;   // keeps float4 alignment, makes the transposed stores conflict-free
constexpr int NT = 256;   // 16 x 16 threads
constexpr float NEG = -1e30f;

__device__ __forceinline__ int row_of(int ty, int i) { return ty * 4 + (i & 3) + (i >> 2) * 64; }
__device__ __forceinline__ int col_of(int tx, int j) { return tx * 4 + (j & 3) + (j >> 2) * 64; }

// VEC_B: V % 4 == 0, so a float4 of a head row is wholly inside or outside
// the vocab and 16-byte aligned; otherwise the head is read one float at a time.
template <bool VEC_B>
__global__ void __launch_bounds__(NT, 2)
    fused_logprob_partial(const float* __restrict__ hid, const float* __restrict__ head,
                          const int* __restrict__ tgt, float* __restrict__ part_m,
                          float* __restrict__ part_s, float* __restrict__ part_c, int N, int D,
                          int V, int tiles_per_split, float inv_temp) {
  __shared__ __align__(16) float As[2][BD][BN + APAD];  // hidden tiles, transposed
  __shared__ __align__(16) float Bs[2][BD][BV];         // head tiles
  // per-thread running (max, sum-exp, chosen) for its 8 rows, touched once
  // per vocab tile: kept here rather than in registers, so that two blocks
  // fit on an SM
  __shared__ float st_m[8][NT], st_s[8][NT], st_c[8][NT];

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int n0 = blockIdx.x * BN;
  const int split = blockIdx.y;
  const int n_vt = (V + BV - 1) / BV;
  const int vt0 = split * tiles_per_split;
  const int vt1 = min(n_vt, vt0 + tiles_per_split);
  const int nk = D / BD;

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    st_m[i][tid] = NEG;
    st_s[i][tid] = 0.f;
    st_c[i][tid] = 0.f;
  }

  // loaders: hidden rows as float4 along D, head rows as float4 along V
  const int a_row = tid >> 1, a_col = (tid & 1) * 4;
  const int b_row = tid >> 5, b_col = (tid & 31) * 4;
  const bool a_ok = n0 + a_row < N;
  const float* a_src = hid + (long long)(n0 + (a_ok ? a_row : 0)) * D + a_col;

  for (int vt = vt0; vt < vt1; ++vt) {
    const int v0 = vt * BV;
    const int bc = v0 + b_col;
    const float* b_src = head + (long long)b_row * V + bc;

    auto load_a = [&](int kt) -> float4 {
      return a_ok ? *reinterpret_cast<const float4*>(a_src + kt * BD)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    };
    auto load_b = [&](int kt) -> float4 {
      const float* src = b_src + (long long)kt * BD * V;
      if (VEC_B) {
        return bc < V ? *reinterpret_cast<const float4*>(src) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      return make_float4(bc < V ? src[0] : 0.f, bc + 1 < V ? src[1] : 0.f,
                         bc + 2 < V ? src[2] : 0.f, bc + 3 < V ? src[3] : 0.f);
    };
    auto store = [&](int buf, float4 ra, float4 rb) {
      As[buf][a_col + 0][a_row] = ra.x;
      As[buf][a_col + 1][a_row] = ra.y;
      As[buf][a_col + 2][a_row] = ra.z;
      As[buf][a_col + 3][a_row] = ra.w;
      *reinterpret_cast<float4*>(&Bs[buf][b_row][b_col]) = rb;
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    store(0, load_a(0), load_b(0));
    __syncthreads();
    for (int kt = 0; kt < nk; ++kt) {
      const int cur = kt & 1;
      float4 ra, rb;
      const bool more = kt + 1 < nk;
      if (more) {  // fetch the next stage while this one is multiplied
        ra = load_a(kt + 1);
        rb = load_b(kt + 1);
      }
#pragma unroll
      for (int kd = 0; kd < BD; ++kd) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kd][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kd][ty * 4 + 64]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kd][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][kd][tx * 4 + 64]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
      // the other stage was last read before the previous barrier
      if (more) store(cur ^ 1, ra, rb);
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = n0 + row_of(ty, i);
      const int t = row < N ? tgt[row] : -1;
      float z[8];
      float mx = NEG, chosen = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = v0 + col_of(tx, j);
        const bool ok = col < V;
        z[j] = ok ? acc[i][j] * inv_temp : NEG;
        mx = fmaxf(mx, z[j]);
        if (ok && col == t) chosen += z[j];
      }
      const float m_old = st_m[i][tid];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += (v0 + col_of(tx, j) < V) ? expf(z[j] - m_new) : 0.f;
      st_s[i][tid] = st_s[i][tid] * expf(m_old - m_new) + sum;
      st_m[i][tid] = m_new;
      st_c[i][tid] += chosen;
    }
  }

  // merge the triples of the 16 threads (one half-warp) that share each row
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float m = st_m[i][tid], s = st_s[i][tid], c = st_c[i][tid];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m, off);
      const float so = __shfl_xor_sync(0xffffffffu, s, off);
      const float co = __shfl_xor_sync(0xffffffffu, c, off);
      const float mn = fmaxf(m, mo);
      s = s * expf(m - mn) + so * expf(mo - mn);
      m = mn;
      c += co;
    }
    const int row = n0 + row_of(ty, i);
    if (tx == 0 && row < N) {
      const long long at = (long long)split * N + row;
      part_m[at] = m;
      part_s[at] = s;
      part_c[at] = c;
    }
  }
}

__global__ void fused_logprob_merge(const float* __restrict__ part_m,
                                    const float* __restrict__ part_s,
                                    const float* __restrict__ part_c, float* __restrict__ out,
                                    float* __restrict__ lse, int N, int n_split) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  float mx = NEG;
  for (int k = 0; k < n_split; ++k) mx = fmaxf(mx, part_m[(long long)k * N + row]);
  float sum = 0.f, chosen = 0.f;
  for (int k = 0; k < n_split; ++k) {
    const long long at = (long long)k * N + row;
    sum += part_s[at] * expf(part_m[at] - mx);
    chosen += part_c[at];
  }
  const float l = mx + logf(sum);
  lse[row] = l;
  out[row] = chosen - l;
}

}  // namespace

// scratch: 3 * n_split * N floats. Returns a cudaError_t: 0 when both
// launches were accepted.
extern "C" int fused_logprob_fwd(const float* hidden, const float* head, const int* targets,
                                 float* out, float* lse, float* scratch, int N, int D, int V,
                                 int n_split, int tiles_per_split, float inv_temp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pm = scratch;
  float* ps = scratch + (long long)n_split * N;
  float* pc = scratch + 2LL * n_split * N;
  const dim3 grid((N + BN - 1) / BN, n_split);
  if (D % BD != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (V % 4 == 0) {
    fused_logprob_partial<true><<<grid, NT, 0, st>>>(hidden, head, targets, pm, ps, pc, N, D,
                                                     V, tiles_per_split, inv_temp);
  } else {
    fused_logprob_partial<false><<<grid, NT, 0, st>>>(hidden, head, targets, pm, ps, pc, N, D,
                                                      V, tiles_per_split, inv_temp);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_logprob_merge<<<(N + 255) / 256, 256, 0, st>>>(pm, ps, pc, out, lse, N, n_split);
  return static_cast<int>(cudaGetLastError());
}
