// Backward of the fused GroupNorm -> ReLU -> K-tap causal conv, FP32, sm_90a.
//
// Replaces the Pallas TPU kernel h36x/ops/pallas_temporal.py::_bwd_kernel
// (reached through _pallas_backward / _fused_bwd). With s_k = K-1-k,
// xh = (x - mean) * rstd, a = xh * scale + bias, r = relu(a) and the
// forward out[t] = cb + sum_k r[max(t - s_k, 0)] @ W[k] (+ res), given the
// output gradient g (B, T, O):
//
//   dr[j]   = sum_k Gk[j] @ W[k]^T,  Gk[j] = g[j + s_k] for j > 0 (0 past T),
//             Gk[0] = g[0] + ... + g[min(s_k, T-1)]  (the replicated edge)
//   da      = dr * (a > 0)
//   dscale  = sum_{b,t} xh * da,  dbias = sum_{b,t} da
//   dx      = rstd * (dxh - E[dxh] - xh * E[dxh * xh]),  dxh = da * scale,
//             E over the (T, D/G) elements of each (sample, group)
//   dW[k]   = sum_{b,t} r[b, max(t - s_k, 0)]^T g[b, t]
//
// The conv-bias and residual gradients (a sum of g, and g) stay outside.
// mean and rstd are the forward kernel's, saved by the autograd Function.
//
// What bounds it on the H100: operations. At the training shape (B = 32,
// T = 40, D = O = 1024, K = 3) the two contractions (dr and dW) are
// 2 * 2*1280*3072*1024 = 16.1 GFLOP over about 41 MB of inputs and
// outputs.
//
// Design: four launches, no atomics, so every sum has one fixed order and a
// step is reproducible.
//   1. dr_gemm: a tiled GEMM over rows (b, j) x input channels d, reducing
//      over (k, o). Its A tile is built from g while it loads: each element
//      reads the shifted row of its own sample, or sums the left-edge rows.
//      W is read transposed in place (threads run along o, which is
//      contiguous). The epilogue recomputes a from x and the saved
//      statistics and stores da.
//   2. gn_bwd: one block per (group, sample) reduces E[dxh] and E[dxh * xh]
//      and writes dx, plus per-(sample, channel) partial sums of xh * da and
//      da over time.
//   3. param_reduce: sums those partials over the samples in order ->
//      dscale, dbias.
//   4. dw_gemm: a tiled GEMM over rows (k, d) x output channels o, reducing
//      over all B*T rows (b, t) inside the block, so the batch sum that the
//      TPU kernel accumulated by revisiting one VMEM block runs in a loop of
//      one block per output tile. Its A tile recomputes r (normalise, affine,
//      ReLU, shifted and clamped to row 0 of its own sample) while it loads.
// Tiles are those of the forward kernel (gemm_tile.cuh): 32 x 64 outputs,
// depth 32, 128 threads, 4 x 4 outputs a thread; the next tile's global
// loads are issued into registers before the current tile is multiplied.

#include <cuda_runtime.h>

#include "gemm_tile.cuh"

namespace {

using namespace h36x;

constexpr int kRedThreads = 256;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

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

// grid (ceil(D/BN), ceil(B*T/BM)), block kThreads
__global__ void __launch_bounds__(kThreads)
dr_gemm(const float* __restrict__ x, const float* __restrict__ scale,
        const float* __restrict__ bias, const float* __restrict__ w,
        const float* __restrict__ g, const float* __restrict__ mean,
        const float* __restrict__ rstd, float* __restrict__ da,
        int B, int T, int D, int O, int K, int G) {
  __shared__ __align__(16) Tile s;
  constexpr int STEP = kThreads / BK;  // rows (or columns) between a thread's loads
  const int M = B * T, KO = K * O, gs = D / G;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid % (BN / TN), ty = tid / (BN / TN);
  // Both operands load reduction column kl, so one (tap, o) cursor serves
  // both, advanced by BK per tile without division.
  const int kl = tid % BK, lane = tid / BK;
  int tap = kl / O, o = kl - (kl / O) * O;
  int a_b[A_ELEMS], a_j[A_ELEMS];
#pragma unroll
  for (int e = 0; e < A_ELEMS; ++e) {
    const int m = m0 + lane + e * STEP;
    a_b[e] = m < M ? m / T : -1;
    a_j[e] = m < M ? m - a_b[e] * T : 0;
  }
  float ra[A_ELEMS], rb[B_ELEMS];

  auto load = [&](int k0) {
    const bool ok = k0 + kl < KO;
    const int sft = K - 1 - tap;
#pragma unroll
    for (int e = 0; e < A_ELEMS; ++e) {
      float v = 0.f;
      if (ok && a_b[e] >= 0) {
        const float* gb = g + (size_t)a_b[e] * T * O + o;
        if (a_j[e] == 0) {
          const int last = min(sft, T - 1);
          for (int t = 0; t <= last; ++t) v += gb[(size_t)t * O];
        } else if (a_j[e] + sft < T) {
          v = gb[(size_t)(a_j[e] + sft) * O];
        }
      }
      ra[e] = v;
    }
#pragma unroll
    for (int e = 0; e < B_ELEMS; ++e) {
      const int d = n0 + lane + e * STEP;
      rb[e] = (ok && d < D) ? w[((size_t)tap * D + d) * O + o] : 0.f;
    }
    o += BK;
    while (o >= O) { o -= O; ++tap; }
  };

  float acc[TM][TN];
  zero_acc(acc);
  load(0);
  for (int k0 = 0; k0 < KO; k0 += BK) {
#pragma unroll
    for (int e = 0; e < A_ELEMS; ++e) s.a[kl][lane + e * STEP] = ra[e];
#pragma unroll
    for (int e = 0; e < B_ELEMS; ++e) s.b[kl][lane + e * STEP] = rb[e];
    __syncthreads();
    if (k0 + BK < KO) load(k0 + BK);  // next tile's loads overlap this tile's math
    tile_fma(s, acc, tx, ty);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
    const int b = m / T;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int d = n0 + tx * TN + j;
      if (d >= D) continue;
      const int gi = b * G + d / gs;
      const size_t off = (size_t)m * D + d;
      const float a = (x[off] - mean[gi]) * rstd[gi] * scale[d] + bias[d];
      da[off] = a > 0.f ? acc[i][j] : 0.f;
    }
  }
}

// grid (G, B), block kRedThreads
__global__ void gn_bwd(const float* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ da, const float* __restrict__ mean,
                       const float* __restrict__ rstd, float* __restrict__ dx,
                       float* __restrict__ part, int B, int T, int D, int G) {
  __shared__ float red[kRedThreads / 32];
  const int grp = blockIdx.x, b = blockIdx.y;
  const int gs = D / G, n = T * gs;
  const size_t base = (size_t)b * T * D + (size_t)grp * gs;
  const float* xb = x + base;
  const float* dab = da + base;
  const float* sc = scale + grp * gs;
  const float mu = mean[b * G + grp], rs = rstd[b * G + grp];

  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int t = i / gs, c = i - t * gs;
    const size_t off = (size_t)t * D + c;
    const float xh = (xb[off] - mu) * rs;
    const float dxh = dab[off] * sc[c];
    s1 += dxh;
    s2 += dxh * xh;
  }
  const float m1 = block_sum(s1, red) / (float)n;
  const float m2 = block_sum(s2, red) / (float)n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int t = i / gs, c = i - t * gs;
    const size_t off = (size_t)t * D + c;
    const float xh = (xb[off] - mu) * rs;
    const float dxh = dab[off] * sc[c];
    dx[base + off] = rs * (dxh - m1 - xh * m2);
  }
  // per-(sample, channel) sums over time, for dscale and dbias
  for (int c = threadIdx.x; c < gs; c += blockDim.x) {
    float ps = 0.f, pb = 0.f;
    for (int t = 0; t < T; ++t) {
      const size_t off = (size_t)t * D + c;
      const float dav = dab[off];
      ps += (xb[off] - mu) * rs * dav;
      pb += dav;
    }
    part[(size_t)b * D + grp * gs + c] = ps;
    part[(size_t)(B + b) * D + grp * gs + c] = pb;
  }
}

// grid ceil(D / kRedThreads), block kRedThreads
__global__ void param_reduce(const float* __restrict__ part, float* __restrict__ dscale,
                             float* __restrict__ dbias, int B, int D) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  float ps = 0.f, pb = 0.f;
  for (int b = 0; b < B; ++b) {
    ps += part[(size_t)b * D + d];
    pb += part[(size_t)(B + b) * D + d];
  }
  dscale[d] = ps;
  dbias[d] = pb;
}

// grid (ceil(O/BN), ceil(K*D/BM)), block kThreads
__global__ void __launch_bounds__(kThreads)
dw_gemm(const float* __restrict__ x, const float* __restrict__ scale,
        const float* __restrict__ bias, const float* __restrict__ g,
        const float* __restrict__ mean, const float* __restrict__ rstd,
        float* __restrict__ dw, int B, int T, int D, int O, int K, int G) {
  __shared__ __align__(16) Tile s;
  constexpr int A_STEP = kThreads / BM;  // reduction rows between a thread's A loads
  constexpr int B_STEP = kThreads / BN;  // ... and B loads
  const int M = B * T, KD = K * D, gs = D / G;
  const int r0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid % (BN / TN), ty = tid / (BN / TN);

  // A: the thread's fixed output row (tap, d), reduction rows a_kl + e*A_STEP
  const int a_r = tid % BM, a_kl = tid / BM;
  const int r = r0 + a_r;
  const bool r_ok = r < KD;
  const int tap = r_ok ? r / D : 0;
  const int d = r_ok ? r - tap * D : 0;
  const int sft = K - 1 - tap, grp = d / gs;
  const float sc = r_ok ? scale[d] : 0.f, bi = r_ok ? bias[d] : 0.f;
  int a_b[A_ELEMS], a_t[A_ELEMS];  // (sample, frame) of each reduction row
#pragma unroll
  for (int e = 0; e < A_ELEMS; ++e) {
    const int m = a_kl + e * A_STEP;
    a_b[e] = m / T;
    a_t[e] = m - a_b[e] * T;
  }
  // B: g's fixed column b_n, reduction rows b_kl + e*B_STEP
  const int b_nl = tid % BN, b_kl = tid / BN;
  const int b_n = n0 + b_nl;
  float ra[A_ELEMS], rb[B_ELEMS];

  auto load = [&](int k0) {
#pragma unroll
    for (int e = 0; e < A_ELEMS; ++e) {
      float v = 0.f;
      if (r_ok && a_b[e] < B) {
        const int src = max(a_t[e] - sft, 0);
        const int gi = a_b[e] * G + grp;
        v = fmaxf((x[((size_t)a_b[e] * T + src) * D + d] - mean[gi]) * rstd[gi] * sc + bi,
                  0.f);
      }
      ra[e] = v;
      a_t[e] += BK;
      while (a_t[e] >= T) { a_t[e] -= T; ++a_b[e]; }
    }
#pragma unroll
    for (int e = 0; e < B_ELEMS; ++e) {
      const int m = k0 + b_kl + e * B_STEP;
      rb[e] = (m < M && b_n < O) ? g[(size_t)m * O + b_n] : 0.f;
    }
  };

  float acc[TM][TN];
  zero_acc(acc);
  load(0);
  for (int k0 = 0; k0 < M; k0 += BK) {
#pragma unroll
    for (int e = 0; e < A_ELEMS; ++e) s.a[a_kl + e * A_STEP][a_r] = ra[e];
#pragma unroll
    for (int e = 0; e < B_ELEMS; ++e) s.b[b_kl + e * B_STEP][b_nl] = rb[e];
    __syncthreads();
    if (k0 + BK < M) load(k0 + BK);
    tile_fma(s, acc, tx, ty);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int rr = r0 + ty * TM + i;
    if (rr >= KD) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < O) dw[(size_t)rr * O + n] = acc[i][j];
    }
  }
}

}  // namespace

// da (B*T*D) and part (2*B*D) are scratch the caller allocates.
extern "C" int h36x_gn_relu_cconv_bwd(const float* x, const float* scale,
                                      const float* bias, const float* w,
                                      const float* g, const float* mean,
                                      const float* rstd, float* da, float* part,
                                      float* dx, float* dw, float* dscale,
                                      float* dbias, int B, int T, int D, int O,
                                      int K, int G, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * T;
  dr_gemm<<<dim3(cdiv(D, BN), cdiv(M, BM)), kThreads, 0, s>>>(
      x, scale, bias, w, g, mean, rstd, da, B, T, D, O, K, G);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_bwd<<<dim3(G, B), kRedThreads, 0, s>>>(x, scale, da, mean, rstd, dx, part,
                                            B, T, D, G);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  param_reduce<<<cdiv(D, kRedThreads), kRedThreads, 0, s>>>(part, dscale, dbias, B, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dw_gemm<<<dim3(cdiv(O, BN), cdiv(K * D, BM)), kThreads, 0, s>>>(
      x, scale, bias, g, mean, rstd, dw, B, T, D, O, K, G);
  return (int)cudaGetLastError();
}
