// Backward of the fused iterative-error-feedback joint regressor, FP32,
// sm_90a.
//
// Replaces the Pallas TPU kernel h36x/ops/pallas_regressor.py::_bwd_kernel
// (reached through _fused_backward / _bwd). The forward (regressor.cu) is
//
//   y_0 = 0;  pw1 = phi @ W1p           (W1p = W1[:D], W1y = W1[D:D+P])
//   h1_i = relu(pw1 + y_i @ W1y + b1);  h2_i = relu(h1_i @ W2 + b2)
//   y_{i+1} = y_i + h2_i @ W3 + b3,  i = 0 .. iters-1
//
// and, given dY = g (N, P) on the output, the unrolled loop backpropagates
// (dY_i is the gradient arriving at y_{i+1}, dY_{iters-1} = g):
//
//   dh2_i = (dY_i @ W3^T) * (h2_i > 0);  dh1_i = (dh2_i @ W2^T) * (h1_i > 0)
//   dY_{i-1} = dY_i + dh1_i @ W1y^T     (y_i feeds h1_i and the identity)
//   dpw1 = sum_i dh1_i;  dphi = dpw1 @ W1p^T;  dW1p = phi^T dpw1
//   dW1y = sum_i y_i^T dh1_i;  dW2 = sum_i h1_i^T dh2_i;  dW3 = sum_i h2_i^T dY_i
//   db1 = sum dh1_i, db2 = sum dh2_i, db3 = sum dY_i   (over rows and rounds)
//
// The gradient has the unpadded P = out_dim columns: nothing is padded to
// 64 here, so no padded column can reach a gradient.
//
// What bounds it on the H100: operations. At the training shape (N = B*T =
// 1280, D = H = 1024, P = 51, 3 rounds) the forward recompute is about
// 11.5 GFLOP and the backward about 23 GFLOP, over about 24 MB of inputs
// and outputs.
//
// Design: the forward's activations are recomputed once for all N rows and
// kept in a device workspace (y_i, h1_i, h2_i and their gradients, about
// 74 MB at the training shape), so every weight gradient becomes one GEMM
// whose reduction runs over all rows of all rounds stacked (3N rows) inside
// one block per output tile: no atomics and no cross-block sums, so the
// order of every sum is fixed and a step is reproducible. The TPU kernel
// summed per-tile partials by revisiting one VMEM block; at this width it
// was never reached there (its VMEM budget sent the step to the XLA vjp).
// All products run through one templated tiled GEMM (the tile of
// gemm_tile.cuh) whose operands may each be read transposed in place, with
// an epilogue that adds a matrix and a bias and applies a ReLU or a ReLU
// mask. The bias gradients are column sums in two fixed-order passes.
// Launches: 1 + 3 * iters - 1 (forward) + 3 * iters - 1 (backward) + 5
// GEMMs, one sum of the dh1_i, three column sums.

#include <cuda_runtime.h>

#include "gemm_tile.cuh"

namespace {

using namespace h36x;

constexpr int kChunks = 16;  // row chunks of the first column-sum pass

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

struct Epi {
  const float* add;   // (M, N) matrix added to the product, or null
  int ldadd;
  const float* bias;  // (N,), or null
  const float* mask;  // (M, N): zero the result where mask <= 0, or null
  int ldmask;
  int relu;
};

// C (M, N) = A (M, K) @ B (K, N), then the epilogue. A is read at
// A[m*lda + k] (TA false) or A[k*lda + m] (TA true); B at B[k*ldb + n]
// (TB false) or B[n*ldb + k] (TB true). Each load layout runs the threads of
// a warp along the operand's contiguous index.
// grid (ceil(N/BN), ceil(M/BM)), block kThreads
template <bool TA, bool TB>
__global__ void __launch_bounds__(kThreads)
gemm(const float* __restrict__ A, int lda, const float* __restrict__ Bm, int ldb,
     float* __restrict__ C, int ldc, int M, int N, int K, Epi ep) {
  __shared__ __align__(16) Tile s;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid % (BN / TN), ty = tid / (BN / TN);
  // (row, k) of A element e and (k, col) of B element e in the tile
  int a_r[A_ELEMS], a_k[A_ELEMS], b_k[B_ELEMS], b_c[B_ELEMS];
#pragma unroll
  for (int e = 0; e < A_ELEMS; ++e) {
    if constexpr (TA) { a_r[e] = tid % BM; a_k[e] = tid / BM + e * (kThreads / BM); }
    else { a_k[e] = tid % BK; a_r[e] = tid / BK + e * (kThreads / BK); }
  }
#pragma unroll
  for (int e = 0; e < B_ELEMS; ++e) {
    if constexpr (TB) { b_k[e] = tid % BK; b_c[e] = tid / BK + e * (kThreads / BK); }
    else { b_c[e] = tid % BN; b_k[e] = tid / BN + e * (kThreads / BN); }
  }
  float ra[A_ELEMS], rb[B_ELEMS];

  auto load = [&](int k0) {
#pragma unroll
    for (int e = 0; e < A_ELEMS; ++e) {
      const int m = m0 + a_r[e], k = k0 + a_k[e];
      ra[e] = (m < M && k < K)
          ? (TA ? A[(size_t)k * lda + m] : A[(size_t)m * lda + k]) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < B_ELEMS; ++e) {
      const int n = n0 + b_c[e], k = k0 + b_k[e];
      rb[e] = (n < N && k < K)
          ? (TB ? Bm[(size_t)n * ldb + k] : Bm[(size_t)k * ldb + n]) : 0.f;
    }
  };

  float acc[TM][TN];
  zero_acc(acc);
  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int e = 0; e < A_ELEMS; ++e) s.a[a_k[e]][a_r[e]] = ra[e];
#pragma unroll
    for (int e = 0; e < B_ELEMS; ++e) s.b[b_k[e]][b_c[e]] = rb[e];
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);  // next tile's loads overlap this tile's math
    tile_fma(s, acc, tx, ty);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= N) continue;
      float v = acc[i][j];
      if (ep.add != nullptr) v += ep.add[(size_t)m * ep.ldadd + n];
      if (ep.bias != nullptr) v += ep.bias[n];
      if (ep.relu) v = fmaxf(v, 0.f);
      if (ep.mask != nullptr && !(ep.mask[(size_t)m * ep.ldmask + n] > 0.f)) v = 0.f;
      C[(size_t)m * ldc + n] = v;
    }
  }
}

// out[i] = sum_{r < stack} x[r * count + i], in order
__global__ void sum_stack(const float* __restrict__ x, int stack, size_t count,
                          float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float v = 0.f;
  for (int r = 0; r < stack; ++r) v += x[(size_t)r * count + i];
  out[i] = v;
}

// column sums of x (rows, cols), pass 1: grid (ceil(cols/32), kChunks),
// block (32, 8); part (kChunks, cols)
__global__ void colsum_part(const float* __restrict__ x, int rows, int cols,
                            float* __restrict__ part) {
  __shared__ float red[8][32];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const int lo = (int)((long long)blockIdx.y * rows / kChunks);
  const int hi = (int)((long long)(blockIdx.y + 1) * rows / kChunks);
  float v = 0.f;
  if (col < cols)
    for (int r = lo + threadIdx.y; r < hi; r += 8) v += x[(size_t)r * cols + col];
  red[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && col < cols) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += red[i][threadIdx.x];
    part[(size_t)blockIdx.y * cols + col] = t;
  }
}

// pass 2: grid ceil(cols/256), block 256
__global__ void colsum_final(const float* __restrict__ part, int cols,
                             float* __restrict__ out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  float v = 0.f;
  for (int c = 0; c < kChunks; ++c) v += part[(size_t)c * cols + col];
  out[col] = v;
}

template <bool TA, bool TB>
cudaError_t run_gemm(cudaStream_t s, const float* A, int lda, const float* B, int ldb,
                     float* C, int ldc, int M, int N, int K, Epi ep = {}) {
  gemm<TA, TB><<<dim3(cdiv(N, BN), cdiv(M, BM)), kThreads, 0, s>>>(
      A, lda, B, ldb, C, ldc, M, N, K, ep);
  return cudaGetLastError();
}

cudaError_t colsum(cudaStream_t s, const float* x, int rows, int cols, float* part,
                   float* out) {
  colsum_part<<<dim3(cdiv(cols, 32), kChunks), dim3(32, 8), 0, s>>>(x, rows, cols, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  colsum_final<<<cdiv(cols, 256), 256, 0, s>>>(part, cols, out);
  return cudaGetLastError();
}

struct Workspace {
  float *pw1, *ys, *h1, *h2, *dh1, *dh2, *dys, *dpw1, *part;
  size_t floats;
  // base null: only count the floats
  Workspace(float* base, int N, int H, int P, int iters) {
    const size_t nh = (size_t)N * H, np = (size_t)N * P;
    size_t off = 0;
    auto take = [&](size_t n) {
      float* q = base != nullptr ? base + off : nullptr;
      off += n;
      return q;
    };
    pw1 = take(nh);
    ys = take(iters * np);
    h1 = take(iters * nh);
    h2 = take(iters * nh);
    dh1 = take(iters * nh);
    dh2 = take(iters * nh);
    dys = take(iters * np);
    dpw1 = take(nh);
    part = take((size_t)kChunks * (H > P ? H : P));
    floats = off;
  }
};

}  // namespace

extern "C" size_t h36x_joint_regressor_bwd_workspace(int N, int H, int P, int iters) {
  return Workspace(nullptr, N, H, P, iters).floats * sizeof(float);
}

// g (N, P) is the gradient of the output; ws holds
// h36x_joint_regressor_bwd_workspace(N, H, P, iters) bytes. dw1 is
// (D + P, H): dW1p goes to its first D rows, dW1y to the last P.
extern "C" int h36x_joint_regressor_bwd(
    const float* phi, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* w3, const float* b3, const float* g, float* ws,
    float* dphi, float* dw1, float* db1, float* dw2, float* db2, float* dw3,
    float* db3, int N, int D, int H, int P, int iters, void* stream) {
  if (iters < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Workspace w(ws, N, H, P, iters);
  const size_t nh = (size_t)N * H, np = (size_t)N * P;
  const float* w1y = w1 + (size_t)D * H;
  cudaError_t err;
#define H36X_TRY(call) \
  if ((err = (call)) != cudaSuccess) return (int)err

  // -- forward recompute, every round's activations kept ------------------
  H36X_TRY(cudaMemsetAsync(w.ys, 0, np * sizeof(float), s));
  H36X_TRY((run_gemm<false, false>(s, phi, D, w1, H, w.pw1, H, N, H, D)));
  for (int it = 0; it < iters; ++it) {
    float* y = w.ys + it * np;
    float* h1 = w.h1 + it * nh;
    float* h2 = w.h2 + it * nh;
    H36X_TRY((run_gemm<false, false>(s, y, P, w1y, H, h1, H, N, H, P,
                                     Epi{w.pw1, H, b1, nullptr, 0, 1})));
    H36X_TRY((run_gemm<false, false>(s, h1, H, w2, H, h2, H, N, H, H,
                                     Epi{nullptr, 0, b2, nullptr, 0, 1})));
    if (it + 1 < iters)
      H36X_TRY((run_gemm<false, false>(s, h2, H, w3, P, y + np, P, N, P, H,
                                       Epi{y, P, b3, nullptr, 0, 0})));
  }

  // -- backward through the unrolled loop ---------------------------------
  H36X_TRY(cudaMemcpyAsync(w.dys + (iters - 1) * np, g, np * sizeof(float),
                           cudaMemcpyDeviceToDevice, s));
  for (int it = iters - 1; it >= 0; --it) {
    const float* dy = w.dys + it * np;
    float* dh2 = w.dh2 + it * nh;
    float* dh1 = w.dh1 + it * nh;
    H36X_TRY((run_gemm<false, true>(s, dy, P, w3, P, dh2, H, N, H, P,
                                    Epi{nullptr, 0, nullptr, w.h2 + it * nh, H, 0})));
    H36X_TRY((run_gemm<false, true>(s, dh2, H, w2, H, dh1, H, N, H, H,
                                    Epi{nullptr, 0, nullptr, w.h1 + it * nh, H, 0})));
    if (it > 0)
      H36X_TRY((run_gemm<false, true>(s, dh1, H, w1y, H, w.dys + (it - 1) * np, P,
                                      N, P, H, Epi{dy, P, nullptr, nullptr, 0, 0})));
  }
  sum_stack<<<(unsigned)((nh + 255) / 256), 256, 0, s>>>(w.dh1, iters, nh, w.dpw1);
  H36X_TRY(cudaGetLastError());
  H36X_TRY((run_gemm<false, true>(s, w.dpw1, H, w1, H, dphi, D, N, D, H)));

  // -- weight gradients: reductions over all rows of all rounds -----------
  const int R = iters * N;
  H36X_TRY((run_gemm<true, false>(s, phi, D, w.dpw1, H, dw1, H, D, H, N)));
  H36X_TRY((run_gemm<true, false>(s, w.ys, P, w.dh1, H, dw1 + (size_t)D * H, H,
                                  P, H, R)));
  H36X_TRY((run_gemm<true, false>(s, w.h1, H, w.dh2, H, dw2, H, H, H, R)));
  H36X_TRY((run_gemm<true, false>(s, w.h2, H, w.dys, P, dw3, P, H, P, R)));
  H36X_TRY(colsum(s, w.dh1, R, H, w.part, db1));
  H36X_TRY(colsum(s, w.dh2, R, H, w.part, db2));
  H36X_TRY(colsum(s, w.dys, R, P, w.part, db3));
#undef H36X_TRY
  return (int)cudaSuccess;
}
