// Fused GroupNorm -> ReLU -> K-tap causal conv (+ residual), FP32, sm_90a.
//
// Replaces the Pallas TPU kernel h36x/ops/pallas_temporal.py::_kernel
// (reached through _fused_gn_relu_cconv_p / fused_gn_relu_cconv /
// fused_residual_block): one half of a PHD residual block.
//
//   out[b, t, :] = cb + sum_k relu(gn(x)[b, max(t - (K-1-k), 0), :]) @ W[k]
//                  (+ res[b, t, :])
//
// with GroupNorm statistics per (sample, group) over (T, D/G), two-pass
// variance, eps inside the square root, and the left edge replicated: a row
// whose tap reaches before t = 0 reads row 0 of its own sample (every tap
// clamps to row 0 when T <= K-1-k).
//
// What bounds it on the H100: operations. At the serving shape (B=16, T=40,
// D=O=1024, K=3) the contraction is 2*640*1024*3072 = 4.03 GFLOP over about
// 20 MB of inputs and outputs (W is 12.6 MB of it), some 200 FLOP per byte.
//
// Design: two launches.
//   1. gn_stats: one block per (group, sample) reduces T*D/G elements twice
//      (mean, then the centred second moment) and writes mean and rstd (B, G).
//   2. cconv_gemm: a tiled FP32 GEMM over rows (b, t) x output channels,
//      reducing over K*D. The A tile is built while it loads: each element
//      reads its shifted, clamped source row, normalises with its group's
//      statistics, applies the affine and the ReLU — so the normalised
//      activation never goes to device memory, as in the TPU kernel, where it
//      stayed in VMEM. Every row carries its own (b, t), so a shifted read
//      never reaches into the previous sample; the ragged edges of M = B*T,
//      N = O and K*D are masked. Conv bias and residual are added in the
//      epilogue. The tiles are 32 x 64 with a depth of 32 and 4 x 4 outputs
//      a thread (128 threads), on the FP32 FMA pipes: at the serving shape
//      that is 320 blocks, two to three on each of the 132 SMs, which a tile
//      sweep on the H100 found faster than larger tiles with fewer blocks.
//      Each thread loads one fixed column of the A tile, so its rows' (b, t)
//      and its channel cursor are set up once and no integer division sits
//      in the loop; the next tile's global loads are issued into registers
//      before the current tile is multiplied; both operands are read from
//      shared memory as float4. TF32/bf16 wgmma, TMA and a resident weight
//      ring are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kStatsThreads = 256;

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read from the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

// grid (G, B), block kStatsThreads
__global__ void gn_stats(const float* __restrict__ x, float* __restrict__ mean,
                         float* __restrict__ rstd, int T, int D, int G, float eps) {
  __shared__ float red[kStatsThreads / 32];
  const int g = blockIdx.x, b = blockIdx.y;
  const int gs = D / G;
  const int n = T * gs;
  const float* xb = x + (size_t)b * T * D + (size_t)g * gs;
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int t = i / gs, c = i - t * gs;
    s += xb[(size_t)t * D + c];
  }
  const float mu = block_sum(s, red) / (float)n;
  float s2 = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int t = i / gs, c = i - t * gs;
    const float dlt = xb[(size_t)t * D + c] - mu;
    s2 += dlt * dlt;
  }
  const float var = block_sum(s2, red) / (float)n;
  if (threadIdx.x == 0) {
    mean[b * G + g] = mu;
    rstd[b * G + g] = 1.0f / sqrtf(var + eps);
  }
}

constexpr int BM = 32, BN = 64, BK = 32, TM = 4, TN = 4;
constexpr int kGemmThreads = (BM / TM) * (BN / TN);  // 128
constexpr int APAD = 4;  // breaks the bank stride of the transposed A store
constexpr int A_ROWS = BM * BK / kGemmThreads;  // A-tile rows each thread loads
constexpr int B_ROWS = BK * BN / kGemmThreads;  // B-tile rows each thread loads
static_assert(kGemmThreads % BK == 0 && kGemmThreads % BN == 0, "load layout");
static_assert(TM % 4 == 0 && TN % 4 == 0, "float4 shared-memory reads");

// grid (ceil(O/BN), ceil(B*T/BM)), block kGemmThreads
__global__ void __launch_bounds__(kGemmThreads)
cconv_gemm(const float* __restrict__ x, const float* __restrict__ scale,
           const float* __restrict__ bias, const float* __restrict__ w,
           const float* __restrict__ cb, const float* __restrict__ res,
           const float* __restrict__ mean, const float* __restrict__ rstd,
           float* __restrict__ out, int B, int T, int D, int O, int K, int G) {
  __shared__ __align__(16) float As[BK][BM + APAD];
  __shared__ __align__(16) float Bs[BK][BN];

  const int M = B * T, KD = K * D, gs = D / G;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);

  // A loads: each thread keeps one reduction column (a_kl) of the tile and
  // rows a_row + 4 e, so its (b, t) bookkeeping is done once, here.
  const int a_kl = tid % BK, a_row = tid / BK;
  int a_bt[A_ROWS], a_t[A_ROWS], a_b[A_ROWS];
#pragma unroll
  for (int e = 0; e < A_ROWS; ++e) {
    const int m = m0 + a_row + e * (kGemmThreads / BK);
    const int b = m < M ? m / T : -1;
    a_b[e] = b;
    a_t[e] = m < M ? m - b * T : 0;
    a_bt[e] = b * T;
  }
  // the column's (tap, channel), advanced by BK per tile without division
  int a_tap = a_kl / D, a_c = a_kl - (a_kl / D) * D;
  // B loads: fixed output column, rows b_kl + 2 e
  const int b_nl = tid % BN, b_kl = tid / BN;
  const int b_n = n0 + b_nl;

  float ra[A_ROWS], rmu[A_ROWS], rrs[A_ROWS], rsc = 0.f, rbi = 0.f, rb[B_ROWS];
  bool rk_ok = false;

  auto load = [&](int k0) {
    rk_ok = k0 + a_kl < KD;
    if (rk_ok) {
      const int g = a_c / gs, shift = K - 1 - a_tap;
      rsc = scale[a_c];
      rbi = bias[a_c];
#pragma unroll
      for (int e = 0; e < A_ROWS; ++e) {
        if (a_b[e] >= 0) {
          const int src = max(a_t[e] - shift, 0);
          ra[e] = x[(size_t)(a_bt[e] + src) * D + a_c];
          rmu[e] = mean[a_b[e] * G + g];
          rrs[e] = rstd[a_b[e] * G + g];
        }
      }
    }
    a_c += BK;
    while (a_c >= D) { a_c -= D; ++a_tap; }
#pragma unroll
    for (int e = 0; e < B_ROWS; ++e) {
      const int kk = k0 + b_kl + e * (kGemmThreads / BN);
      rb[e] = (kk < KD && b_n < O) ? w[(size_t)kk * O + b_n] : 0.f;
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  load(0);
  for (int k0 = 0; k0 < KD; k0 += BK) {
    // normalise + affine + ReLU on the way into shared memory
#pragma unroll
    for (int e = 0; e < A_ROWS; ++e) {
      const float v = (rk_ok && a_b[e] >= 0)
          ? fmaxf((ra[e] - rmu[e]) * rrs[e] * rsc + rbi, 0.f) : 0.f;
      As[a_kl][a_row + e * (kGemmThreads / BK)] = v;
    }
#pragma unroll
    for (int e = 0; e < B_ROWS; ++e) Bs[b_kl + e * (kGemmThreads / BN)][b_nl] = rb[e];
    __syncthreads();
    if (k0 + BK < KD) load(k0 + BK);  // next tile's loads overlap this tile's math
#pragma unroll
    for (int kl = 0; kl < BK; ++kl) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&As[kl][ty * TM + i]);
        a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&Bs[kl][tx * TN + j]);
        bv[j] = v.x; bv[j + 1] = v.y; bv[j + 2] = v.z; bv[j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= O) continue;
      float v = acc[i][j] + cb[n];
      if (res != nullptr) v += res[(size_t)m * O + n];
      out[(size_t)m * O + n] = v;
    }
  }
}

}  // namespace

extern "C" int h36x_gn_relu_cconv(const float* x, const float* scale,
                                  const float* bias, const float* w,
                                  const float* cb, const float* res,
                                  float* mean, float* rstd, float* out,
                                  int B, int T, int D, int O, int K, int G,
                                  float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gn_stats<<<dim3(G, B), kStatsThreads, 0, s>>>(x, mean, rstd, T, D, G, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((O + BN - 1) / BN, (B * T + BM - 1) / BM);
  cconv_gemm<<<grid, kGemmThreads, 0, s>>>(x, scale, bias, w, cb, res, mean,
                                           rstd, out, B, T, D, O, K, G);
  return (int)cudaGetLastError();
}
