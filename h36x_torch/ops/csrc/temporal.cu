// Fused GroupNorm -> ReLU -> K-tap causal conv (+ residual), sm_90a.
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
// clamps to row 0 when T <= K-1-k). x and res may be the first T rows of
// each sample of a longer buffer: their samples lie x_rows and res_rows rows
// apart (T when dense), rows D and O elements apart. The autoregressive
// rollout reads its growing prefix that way, without a copy.
//
// Two routes, as h36x's `precise` switch has two matmul modes
// (pallas_temporal.py::_dot32): the precise route (FP32 throughout; the
// training path and parity) and the fast route (the weights rounded to
// bf16, the activation carried as a bf16 pair, products summed in f32 on
// the tensor cores; the serving paths, under h36x's ~1e-3 serving
// contract). The pair (hi = bf16(v), lo = bf16(v - hi), about 16
// significant bits) keeps the result a continuous function of the
// activation: with a single bf16 rounding, two summation orders of the
// same upstream sums round now and then to neighbouring bf16 values, and
// through a model's blocks and the regressor's rounds those jumps of one
// bf16 step add up, so that a kernel path and its plain version (or two
// batch sizes) would disagree far beyond their summation orders.
//
// What bounds it on the H100: at the serving shape (B=16, T=40, D=O=1024,
// K=3) the contraction is 2*640*1024*3072 = 4.03 GFLOP over about 11.5 MB
// of bf16 weights and f32 activations: operations, 0.0041 ms at the bf16
// peak (0.060 ms at the FP32 peak); the fast route's pair doubles the
// products it issues. At one streamed frame's B=1 it is the 6.3 MB of bf16
// weights, 0.002 ms; at these sizes launch latency, not the bound, sets the
// pace.
//
// The precise route: two launches.
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
//      epilogue. The tile (gemm_tile.cuh, shared with the backward kernels)
//      is 32 x 64 with a depth of 32 and 4 x 4 outputs a thread (128
//      threads), on the FP32 FMA pipes: at the serving shape
//      that is 320 blocks, two to three on each of the 132 SMs, which a tile
//      sweep on the H100 found faster than larger tiles with fewer blocks.
//      Each thread loads one fixed column of the A tile, so its rows' (b, t)
//      and its channel cursor are set up once and no integer division sits
//      in the loop; the next tile's global loads are issued into registers
//      before the current tile is multiplied; both operands are read from
//      shared memory as float4.
//
// The fast route (D a multiple of 64, O of 64): two launches as well.
//   1. gn_act_taps: one block per (group, sample) takes the same two-pass
//      statistics, writes mean and rstd, and writes the activation
//      relu(gn(x) * scale + bias) as a bf16 pair straight into the GEMM's A
//      operand, (B*T, K*D) for each half: row (b, t), columns k*D .. hold
//      the frame of tap k, max(t - (K-1-k), 0), so the shift and the
//      replicated left edge are done here, once (7.9 MB at B 16, K 3).
//   2. hopper.cuh's TMA + wgmma GEMM over K = 2*K*D: the pair's hi half,
//      then its lo half, both read by TMA as they lie, against the same
//      rows of the weights (K*D, O) in bf16, read MN-major as they lie
//      (two K segments). The f32 epilogue adds the conv bias and the strided
//      residual from the registers. The result does not depend on the
//      order in which blocks run, so it is the same bit for bit from run
//      to run, and the strided call equals the dense one.
//   A is written by the prologue rather than copied tap by tap inside the
//   GEMM (the implicit 3x3's 16-byte cp.async copier), and K is not split
//   across blocks at a few rows: on the H100 those copies fed a K stage
//   several times slower than TMA, and a launch of many split blocks cost
//   more than the blocks saved (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_tile.cuh"
#include "hopper.cuh"

namespace {

using namespace h36x;

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
                         float* __restrict__ rstd, int T, int D, int G, float eps,
                         int x_rows) {
  __shared__ float red[kStatsThreads / 32];
  const int g = blockIdx.x, b = blockIdx.y;
  const int gs = D / G;
  const int n = T * gs;
  const float* xb = x + (size_t)b * x_rows * D + (size_t)g * gs;
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

// grid (ceil(O/BN), ceil(B*T/BM)), block kThreads
__global__ void __launch_bounds__(kThreads)
cconv_gemm(const float* __restrict__ x, const float* __restrict__ scale,
           const float* __restrict__ bias, const float* __restrict__ w,
           const float* __restrict__ cb, const float* __restrict__ res,
           const float* __restrict__ mean, const float* __restrict__ rstd,
           float* __restrict__ out, int B, int T, int D, int O, int K, int G,
           int x_rows, int res_rows) {
  __shared__ __align__(16) Tile s;

  const int M = B * T, KD = K * D, gs = D / G;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);

  // A loads: each thread keeps one reduction column (a_kl) of the tile and
  // rows a_row + 4 e, so its (b, t) bookkeeping is done once, here.
  const int a_kl = tid % BK, a_row = tid / BK;
  int a_bt[A_ELEMS], a_t[A_ELEMS], a_b[A_ELEMS];
#pragma unroll
  for (int e = 0; e < A_ELEMS; ++e) {
    const int m = m0 + a_row + e * (kThreads / BK);
    const int b = m < M ? m / T : -1;
    a_b[e] = b;
    a_t[e] = m < M ? m - b * T : 0;
    a_bt[e] = b * x_rows;  // the sample's first row in x
  }
  // the column's (tap, channel), advanced by BK per tile without division
  int a_tap = a_kl / D, a_c = a_kl - (a_kl / D) * D;
  // B loads: fixed output column, rows b_kl + 2 e
  const int b_nl = tid % BN, b_kl = tid / BN;
  const int b_n = n0 + b_nl;

  float ra[A_ELEMS], rmu[A_ELEMS], rrs[A_ELEMS], rsc = 0.f, rbi = 0.f, rb[B_ELEMS];
  bool rk_ok = false;

  auto load = [&](int k0) {
    rk_ok = k0 + a_kl < KD;
    if (rk_ok) {
      const int g = a_c / gs, shift = K - 1 - a_tap;
      rsc = scale[a_c];
      rbi = bias[a_c];
#pragma unroll
      for (int e = 0; e < A_ELEMS; ++e) {
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
    for (int e = 0; e < B_ELEMS; ++e) {
      const int kk = k0 + b_kl + e * (kThreads / BN);
      rb[e] = (kk < KD && b_n < O) ? w[(size_t)kk * O + b_n] : 0.f;
    }
  };

  float acc[TM][TN];
  zero_acc(acc);

  load(0);
  for (int k0 = 0; k0 < KD; k0 += BK) {
    // normalise + affine + ReLU on the way into shared memory
#pragma unroll
    for (int e = 0; e < A_ELEMS; ++e) {
      const float v = (rk_ok && a_b[e] >= 0)
          ? fmaxf((ra[e] - rmu[e]) * rrs[e] * rsc + rbi, 0.f) : 0.f;
      s.a[a_kl][a_row + e * (kThreads / BK)] = v;
    }
#pragma unroll
    for (int e = 0; e < B_ELEMS; ++e) s.b[b_kl + e * (kThreads / BN)][b_nl] = rb[e];
    __syncthreads();
    if (k0 + BK < KD) load(k0 + BK);  // next tile's loads overlap this tile's math
    tile_fma(s, acc, tx, ty);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
    const float* res_row = res == nullptr ? nullptr
        : res + (size_t)(m + (m / T) * (res_rows - T)) * O;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= O) continue;
      float v = acc[i][j] + cb[n];
      if (res_row != nullptr) v += res_row[n];
      out[(size_t)m * O + n] = v;
    }
  }
}

// ---- the fast route ---------------------------------------------------------

namespace hp = h36x_hopper;

// grid (G, B), block kStatsThreads: gn_stats, then the activation v =
// relu(gn(x) * scale + bias) as a bf16 pair (hi = bf16(v), lo = bf16(v -
// hi)), written straight into the GEMM's A: row (b, t), columns k*D + c
// hold v at (b, max(t - (K-1-k), 0), c) for each tap k, so that A is a
// plain (B*T, K*D) matrix that TMA reads as it lies
__global__ void gn_act_taps(const float* __restrict__ x, const float* __restrict__ scale,
                            const float* __restrict__ bias, float* __restrict__ mean,
                            float* __restrict__ rstd, __nv_bfloat16* __restrict__ a_hi,
                            __nv_bfloat16* __restrict__ a_lo, int T, int D, int G, int K,
                            float eps, int x_rows) {
  __shared__ float red[kStatsThreads / 32];
  const int g = blockIdx.x, b = blockIdx.y;
  const int gs = D / G;
  const int n = T * gs;
  const float* xb = x + (size_t)b * x_rows * D + (size_t)g * gs;
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
  const float rs = 1.0f / sqrtf(var + eps);
  if (threadIdx.x == 0) {
    mean[b * G + g] = mu;
    rstd[b * G + g] = rs;
  }
  const size_t KD = (size_t)K * D;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int t = i / gs, c = i - t * gs, ch = g * gs + c;
    const float v = fmaxf((xb[(size_t)t * D + c] - mu) * rs * scale[ch] + bias[ch], 0.f);
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    const __nv_bfloat16 lo = __float2bfloat16_rn(v - __bfloat162float(hi));
    // frame t feeds output row t + (K-1-k) through tap k; frame 0 also
    // feeds the rows whose tap reaches before t = 0
    for (int k = 0; k < K; ++k) {
      const int shift = K - 1 - k;
      const int first = t == 0 ? 0 : t + shift, last = t + shift;
      for (int r = first; r <= last && r < T; ++r) {
        const size_t at = ((size_t)b * T + r) * KD + (size_t)k * D + ch;
        a_hi[at] = hi;
        a_lo[at] = lo;
      }
    }
  }
}

// out = acc + cb (+ res), f32, straight from the accumulators, 8 bytes a
// thread; res row (b, t) lies at b * res_rows + t
struct BiasResF32 {
  struct Args {
    const float* bias;  // (N,)
    const float* res;   // or nullptr
    float* out;         // (M, N)
    int T, res_rows;
  };
  template <int BN>
  static constexpr int bytes() {
    return 0;
  }
  template <int BN>
  __device__ static void store(float (&d)[BN / 2], const Args& a, long long M, int N,
                               long long m0, int n0, uint8_t*, int, int tid) {
    const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long m = m0 + 16 * warp + (lane >> 2) + 8 * i;
      if (m >= M) continue;
      const float* res_row = a.res == nullptr ? nullptr
          : a.res + ((m / a.T) * a.res_rows + m % a.T) * N;
      float* out_row = a.out + m * N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * (lane & 3);
        const float2 cb = *reinterpret_cast<const float2*>(a.bias + n);
        float v0 = d[4 * j + 2 * i] + cb.x, v1 = d[4 * j + 2 * i + 1] + cb.y;
        if (res_row != nullptr) {
          const float2 r = *reinterpret_cast<const float2*>(res_row + n);
          v0 += r.x;
          v1 += r.y;
        }
        *reinterpret_cast<float2*>(out_row + n) = make_float2(v0, v1);
      }
    }
  }
};

template <int BN>
using CconvGemm = hp::Gemm<__nv_bfloat16, BN, true, false, BiasResF32>;

size_t round_up(size_t v) { return (v + 1023) / 1024 * 1024; }

// bytes of each half of the fast route's A: (B*T, K*D) bf16
size_t taps_bytes(int B, int T, int D, int K) {
  return round_up((size_t)B * T * K * D * sizeof(__nv_bfloat16));
}

template <int BN>
int cconv_fast(hp::Params<BiasResF32> p, const void* a_hi, const void* a_lo, const void* w,
               cudaStream_t stream) {
  const int kd = p.seg[0].end;
  int err = hp::make_map(&p.a[0], a_hi, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, kd, p.M, 2ull * kd,
                         64, hp::BM);
  if (!err)
    err = hp::make_map(&p.a[1], a_lo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, kd, p.M, 2ull * kd, 64,
                       hp::BM);
  if (!err)
    err = hp::make_map(&p.b[0], w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.N, kd, 2ull * p.N, 64,
                       64);
  if (err) return err;
  return hp::launch_gemm<CconvGemm<BN>>(p, stream);
}

}  // namespace

extern "C" int h36x_gn_relu_cconv(const float* x, const float* scale,
                                  const float* bias, const float* w,
                                  const float* cb, const float* res,
                                  float* mean, float* rstd, float* out,
                                  int B, int T, int D, int O, int K, int G,
                                  float eps, int x_rows, int res_rows,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gn_stats<<<dim3(G, B), kStatsThreads, 0, s>>>(x, mean, rstd, T, D, G, eps, x_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((O + BN - 1) / BN, (B * T + BM - 1) / BM);
  cconv_gemm<<<grid, kThreads, 0, s>>>(x, scale, bias, w, cb, res, mean,
                                           rstd, out, B, T, D, O, K, G, x_rows, res_rows);
  return (int)cudaGetLastError();
}

// bytes of the fast route's workspace for these shapes (0: shapes it does
// not take: D or O not a multiple of 64, or no rows)
extern "C" size_t h36x_gn_relu_cconv_fast_workspace(int B, int T, int D, int O, int K) {
  if (B <= 0 || T <= 0 || D % 64 || O % 64 || K <= 0) return 0;
  return 2 * taps_bytes(B, T, D, K);
}

// The fast route. w_bf16 is the (K*D, O) bf16 copy of the weights; ws holds
// h36x_gn_relu_cconv_fast_workspace(B, T, D, O, K) bytes, 1024-aligned: A's
// hi and lo halves. Returns the first launch's CUDA error, or 0.
extern "C" int h36x_gn_relu_cconv_fast(const float* x, const float* scale, const float* bias,
                                       const void* w_bf16, const float* cb, const float* res,
                                       float* mean, float* rstd, void* ws, float* out, int B,
                                       int T, int D, int O, int K, int G, float eps,
                                       int x_rows, int res_rows, void* stream) {
  if (h36x_gn_relu_cconv_fast_workspace(B, T, D, O, K) == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* a_hi = static_cast<__nv_bfloat16*>(ws);
  __nv_bfloat16* a_lo = reinterpret_cast<__nv_bfloat16*>(static_cast<uint8_t*>(ws) +
                                                         taps_bytes(B, T, D, K));
  gn_act_taps<<<dim3(G, B), kStatsThreads, 0, s>>>(x, scale, bias, mean, rstd, a_hi, a_lo, T,
                                                  D, G, K, eps, x_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hp::Params<BiasResF32> p{};
  p.M = (long long)B * T;
  p.N = O;
  // the pair's hi half, then its lo half, against the same rows of B
  hp::add_seg(p, 0, 0, K * D);
  hp::add_seg(p, 1, 0, K * D);
  p.epi = {cb, res, out, T, res_rows};
  return O % 128 == 0 ? cconv_fast<128>(p, a_hi, a_lo, w_bf16, s)
                      : cconv_fast<64>(p, a_hi, a_lo, w_bf16, s);
}
