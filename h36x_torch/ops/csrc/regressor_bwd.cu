// Backward of the fused iterative-error-feedback joint regressor, sm_90a.
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
// What bounds it on the H100: operations. At the training shape (N = B*T =
// 1280, D = H = 1024, P = 51, 3 rounds) the forward recompute is about
// 11.5 GFLOP and the backward about 23 GFLOP, over about 24 MB of inputs
// and outputs: 0.035 ms at the bf16 peak with the products counted once,
// 0.209 ms for the six passes of the bf16 split, 0.515 ms at the FP32
// peak.
//
// Two routes, chosen by the wrapper from the shapes alone
// (h36x_torch/ops/regressor.py::regressor_bwd_route). Both recompute the
// forward's activations once for all N rows and keep them in a device
// workspace, so that every weight gradient becomes one GEMM over the rows
// of all rounds stacked; neither uses atomics, so the order of every sum is
// fixed and a step is reproducible bit for bit. The TPU kernel summed
// per-tile partials by revisiting one VMEM block; at this width it was
// never reached there (its VMEM budget sent the step to the XLA vjp).
//
// The hopper route (D and H multiples of 64, P <= 64), float32 accuracy on
// the tensor cores, as the temporal backward's (temporal_bwd.cu): every
// float32 operand split into three bf16 parts, every product six passes
// summed in f32 by hopper.cuh's TMA + wgmma GEMM (split_passes), every
// four K stages promoted into a separate f32 sum (PROMOTE). P is
// padded with zeros to P_PAD = 64 (W1y's rows, W3's columns, g's columns),
// so the padded columns of every y_i and dY_i are exactly zero and the
// gradients come back at P. Launches, in order:
//   1. a prologue splits phi and the weights (once, read as they lie:
//      MN-major as the forward's B, K-major as the backward's B^T), writes
//      g into the f32 dY and its running sum, and y_0 = 0;
//   2. the forward's GEMMs (pw1, then per round [h1,] h2[, y]) and the
//      backward's (per round dh2, dh1[, dY_{i-1}], then dphi), each
//      epilogue splitting its activation or gradient for the next product,
//      keeping the f32 values the later ones add to (pw1, y, dY), reading
//      the ReLU masks from the largest parts, and summing dh1 (= dpw1), dh2
//      and dY over rounds in f32 in one fixed order (the last round first);
//   3. the weight gradients dW1p, dW1y, dW2, dW3: A (phi, y, h1, h2 stacked
//      over rounds) read MN-major as it lies through wgmma's transpose bit,
//      B (dpw1, dh1, dh2, dY) MN-major; each split over consecutive row
//      ranges into enough partial products to fill the card (dW2's 64
//      tiles of 1024 x 1024 would leave half of the SMs idle, dW1y's and
//      dW3's 8 tiles nearly all), which a second launch sums in order;
//   4. the bias gradients: column sums of those f32 sums.
// The 64-wide y and dY phases (10 tiles at N = 1280) are split over K like
// the weight gradients, their epilogue applied by the launch that sums the
// partial products (gemm_filled). The phases are separate launches: they
// take three GEMM kinds (A and B K- or MN-major) and two tile widths, which
// hopper.cuh's one-kernel chain (one instantiation for all phases) cannot
// hold; the gaps between the launches are what a chain could save (PERF.md).
// Rows that are no multiple of 64 (N, or the stacked rounds) are padded by
// TMA's zero fill past the tensor.
//
// The general route (any widths: the first design, FP32 on the CUDA cores):
// all products run through one templated tiled GEMM (the tile of
// gemm_tile.cuh) whose operands may each be read transposed in place, with
// an epilogue that adds a matrix and a bias and applies a ReLU or a ReLU
// mask; every weight gradient's reduction runs over all 3N rows inside one
// block per output tile. The bias gradients are column sums in two
// fixed-order passes. Launches: 1 + 3 * iters - 1 (forward) + 3 * iters - 1
// (backward) + 5 GEMMs, one sum of the dh1_i, three column sums. Its
// gradient has the unpadded P = out_dim columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_tile.cuh"
#include "hopper.cuh"

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

// column sums of x (rows, cols; rows ld apart), pass 1: grid (ceil(cols/32),
// kChunks), block (32, 8); part (kChunks, cols)
__global__ void colsum_part(const float* __restrict__ x, int rows, int cols, int ld,
                            float* __restrict__ part) {
  __shared__ float red[8][32];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const int lo = (int)((long long)blockIdx.y * rows / kChunks);
  const int hi = (int)((long long)(blockIdx.y + 1) * rows / kChunks);
  float v = 0.f;
  if (col < cols)
    for (int r = lo + threadIdx.y; r < hi; r += 8) v += x[(size_t)r * ld + col];
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

cudaError_t colsum(cudaStream_t s, const float* x, int rows, int cols, int ld, float* part,
                   float* out) {
  colsum_part<<<dim3(cdiv(cols, 32), kChunks), dim3(32, 8), 0, s>>>(x, rows, cols, ld, part);
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

// ---- the hopper route ---------------------------------------------------------

namespace hp = h36x_hopper;
using bf16 = __nv_bfloat16;

constexpr int P_PAD = 64;  // the padded width of y and dY
constexpr int MAX_JOBS = 8;

constexpr int PARTS = 3;  // bf16 parts of each float32 operand
constexpr int PROMOTE_STAGES = 4;  // K stages a promoted accumulator takes (hopper.cuh)

// one region of the prologue: dst (rows, cols) from src (its first
// src_rows x src_cols, rows src_ld apart; zero elsewhere, or everywhere
// when src is null), split into three bf16 parts `half` elements apart
// and/or as f32 copies
struct Job {
  const float* src;
  int src_ld, src_rows, src_cols;
  long long rows;
  int cols;
  bf16* parts;  // or null
  long long half;
  float *f32, *f32b;  // or null
};

struct Jobs {
  Job job[MAX_JOBS];
  int n;
};

// grid-stride over the jobs' elements, one after the other
__global__ void split_prologue(const __grid_constant__ Jobs jobs) {
  long long total = 0;
  for (int j = 0; j < jobs.n; ++j) total += jobs.job[j].rows * jobs.job[j].cols;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += step) {
    long long e = i;
    int j = 0;
    for (;;) {
      const long long size = jobs.job[j].rows * jobs.job[j].cols;
      if (e < size) break;
      e -= size;
      ++j;
    }
    const Job& jb = jobs.job[j];
    const long long r = e / jb.cols;
    const int c = (int)(e - r * jb.cols);
    const float v = jb.src != nullptr && r < jb.src_rows && c < jb.src_cols
                        ? jb.src[r * jb.src_ld + c] : 0.f;
    if (jb.parts != nullptr) {
      const bf16 p0 = __float2bfloat16_rn(v);
      const float rest = v - __bfloat162float(p0);
      const bf16 p1 = __float2bfloat16_rn(rest);
      jb.parts[e] = p0;
      jb.parts[jb.half + e] = p1;
      jb.parts[2 * jb.half + e] = __float2bfloat16_rn(rest - __bfloat162float(p1));
    }
    if (jb.f32 != nullptr) jb.f32[e] = v;
    if (jb.f32b != nullptr) jb.f32b[e] = v;
  }
}

enum Stage { kPw1, kH1, kH2, kY, kDh2, kDh1, kDy, kOut };

// The epilogues, one per stage, chosen at run time (uniform across the
// grid), from the accumulators v; `out` takes a value split into three
// bf16 parts (`half` elements apart), offsets m * N + n:
//   kPw1: pw1 = v (f32), h1_0 = relu(v + b1) split
//   kH1:  h1 = relu(pw1 + v + b1)
//   kH2:  h2 = relu(v + b2)
//   kY:   y = y + v + b3 (y = v + b3 in round 1; b3 has P columns, the rest
//         of the 64 add 0), f32 and split
//   kDh2: dh2 = v * (h2 > 0) split; f32 += dh2 (= dh2 in the first round)
//   kDh1: dh1 = v * (h1 > 0) split; f32 += dh1 (dpw1), and in the last
//         round dpw1 split into out2
//   kDy:  dY = dY + v (f32, in place) and split; f32b += dY
//   kOut: f32 = v
struct BwdEpi {
  struct Args {
    int stage, first, P;
    const float* bias;
    float* f32;
    float* f32b;
    const bf16* mask;  // the largest part of the activation whose ReLU masks v
    bf16* out;
    long long half;
    bf16* out2;
    long long half2;
  };

  // the stage's epilogue for the two values v0, v1 at (row, column n) =
  // offset off of an (M, N) output
  __device__ static __forceinline__ void apply(const Args& a, long long off, int n, float v0,
                                               float v1) {
    float2* f = reinterpret_cast<float2*>(a.f32 + off);
    switch (a.stage) {
      case kPw1: {
        *f = make_float2(v0, v1);
        const float2 b = *reinterpret_cast<const float2*>(a.bias + n);
        hp::store_split3(a.out, a.half, off, fmaxf(v0 + b.x, 0.f), fmaxf(v1 + b.y, 0.f));
        break;
      }
      case kH1: {
        const float2 pw = *f;
        const float2 b = *reinterpret_cast<const float2*>(a.bias + n);
        hp::store_split3(a.out, a.half, off, fmaxf(pw.x + v0 + b.x, 0.f),
                         fmaxf(pw.y + v1 + b.y, 0.f));
        break;
      }
      case kH2: {
        const float2 b = *reinterpret_cast<const float2*>(a.bias + n);
        hp::store_split3(a.out, a.half, off, fmaxf(v0 + b.x, 0.f), fmaxf(v1 + b.y, 0.f));
        break;
      }
      case kY: {
        if (!a.first) {
          const float2 y = *f;
          v0 = y.x + v0;
          v1 = y.y + v1;
        }
        v0 += n < a.P ? a.bias[n] : 0.f;
        v1 += n + 1 < a.P ? a.bias[n + 1] : 0.f;
        *f = make_float2(v0, v1);
        hp::store_split3(a.out, a.half, off, v0, v1);
        break;
      }
      case kDh2:
      case kDh1: {
        const __nv_bfloat162 mk = *reinterpret_cast<const __nv_bfloat162*>(a.mask + off);
        v0 = __low2float(mk) > 0.f ? v0 : 0.f;
        v1 = __high2float(mk) > 0.f ? v1 : 0.f;
        hp::store_split3(a.out, a.half, off, v0, v1);
        if (!a.first) {
          const float2 t = *f;
          v0 = t.x + v0;
          v1 = t.y + v1;
        }
        *f = make_float2(v0, v1);
        if (a.out2 != nullptr) hp::store_split3(a.out2, a.half2, off, v0, v1);
        break;
      }
      case kDy: {
        const float2 y = *f;
        v0 = y.x + v0;
        v1 = y.y + v1;
        *f = make_float2(v0, v1);
        float2* sum = reinterpret_cast<float2*>(a.f32b + off);
        const float2 t = *sum;
        *sum = make_float2(t.x + v0, t.y + v1);
        hp::store_split3(a.out, a.half, off, v0, v1);
        break;
      }
      default:
        *f = make_float2(v0, v1);
    }
  }

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
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * (lane & 3);
        apply(a, m * N + n, n, d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
      }
    }
  }
};

// a stage's epilogue after a split product: v = sum_{s < splits} part[s]
// (in order) for each pair of columns of the (M, N) output, then
// BwdEpi::apply
__global__ void finish_splits(const float* __restrict__ part, int splits, long long M, int N,
                              const __grid_constant__ BwdEpi::Args a) {
  const long long pairs = M * N / 2, step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < pairs; i += step) {
    const long long off = 2 * i;
    float2 v = make_float2(0.f, 0.f);
    for (int sp = 0; sp < splits; ++sp) {
      const float2 u = *reinterpret_cast<const float2*>(part + sp * M * N + off);
      v.x += u.x;
      v.y += u.y;
    }
    BwdEpi::apply(a, off, (int)(off % N), v.x, v.y);
  }
}

// the forward's products (B = a weight (K, N) read MN-major as it lies),
// the backward's (B = a weight (N, K) read K-major: W^T), the weight
// gradients' (A and B both MN-major: X^T G over the stacked rows)
template <int BN>
using FwdGemm = hp::Gemm<bf16, BN, true, false, BwdEpi, false, PARTS, PROMOTE_STAGES>;
template <int BN>
using BwdGemm = hp::Gemm<bf16, BN, false, false, BwdEpi, false, PARTS, PROMOTE_STAGES>;
template <int BN>
using WgtGemm = hp::Gemm<bf16, BN, true, false, BwdEpi, true, PARTS, PROMOTE_STAGES>;

enum Kind { kFwd, kBwd, kWgt };

// a float32 tensor split into three bf16 parts, `half` elements apart
struct Parts {
  bf16* p;
  long long half;
  Parts at(long long off) const { return {p + off, half}; }
};

// row ranges of a weight gradient's K: `splits` products of split_k rows
struct Split {
  int splits, split_k;
};

long long tiles_of(long long M, int N, int bn) { return (M + hp::BM - 1) / hp::BM * (N / bn); }

// 128-column tiles, but 64 for a contraction of one K stage a pass (the h1
// and dh2 phases), whose time is the epilogue's: twice the tiles spread it
// over the SMs
int bn_of(int N, long long K) { return N % 128 == 0 && K > 64 ? 128 : 64; }

// enough row ranges that the weight gradient (M, N) over `rows` fills the card
Split split_of(long long M, int N, long long rows) {
  const long long tiles = tiles_of(M, N, bn_of(N, rows)), sms = hp::sm_count();
  const long long chunks = (rows + 63) / 64;
  long long want = tiles >= sms ? 1 : sms / tiles;
  if (want > chunks) want = chunks;
  const long long per = (chunks + want - 1) / want;
  return {(int)((chunks + per - 1) / per), (int)(per * 64)};
}

// C (M, N) = A (M, K) . B (K, N) in six passes, then the epilogue. A is
// (M, K) row-major (kFwd, kBwd) or (K, M) (kWgt); B is (K, N) row-major
// (kFwd, kWgt) or (N, K) (kBwd); K rows past the tensors read as zeros.
template <int BN>
int gemm_bn(Kind kind, long long M, int N, long long K, Parts a, Parts b, Split sp,
            const BwdEpi::Args& epi, cudaStream_t s) {
  const auto BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  hp::Params<BwdEpi, PARTS> p{};
  int err = 0;
  for (int h = 0; h < PARTS && !err; ++h) {
    const bf16* ap = a.p + h * a.half;
    const bf16* bp = b.p + h * b.half;
    if (kind == kWgt)
      err = hp::make_map(&p.a[h], ap, BF16, M, K, 2ull * M, 64, 64);
    else
      err = hp::make_map(&p.a[h], ap, BF16, K, M, 2ull * K, 64, hp::BM);
    if (!err) {
      if (kind == kBwd)
        err = hp::make_map(&p.b[h], bp, BF16, K, N, 2ull * K, 64, BN);
      else
        err = hp::make_map(&p.b[h], bp, BF16, N, K, 2ull * N, 64, 64);
    }
  }
  if (err) return err;
  p.M = M;
  p.N = N;
  const int len = sp.splits > 1 ? sp.split_k : (int)((K + 63) / 64 * 64);
  hp::split_passes(p, PARTS, len);
  p.splits = sp.splits;
  p.split_k = sp.split_k;
  p.epi = epi;
  switch (kind) {
    case kFwd:
      if (!hp::fits<FwdGemm<BN>>(p)) return (int)cudaErrorInvalidValue;
      return hp::launch_gemm<FwdGemm<BN>>(p, s);
    case kBwd:
      if (!hp::fits<BwdGemm<BN>>(p)) return (int)cudaErrorInvalidValue;
      return hp::launch_gemm<BwdGemm<BN>>(p, s);
    default:
      if (!hp::fits<WgtGemm<BN>>(p)) return (int)cudaErrorInvalidValue;
      return hp::launch_gemm<WgtGemm<BN>>(p, s);
  }
}

int gemm(Kind kind, long long M, int N, long long K, Parts a, Parts b, const BwdEpi::Args& epi,
         cudaStream_t s, Split sp = {1, 0}) {
  return bn_of(N, K) == 128 ? gemm_bn<128>(kind, M, N, K, a, b, sp, epi, s)
                            : gemm_bn<64>(kind, M, N, K, a, b, sp, epi, s);
}

// the same, split over consecutive row ranges of K into `part` when the
// output alone would leave most of the card idle (the 64-wide y and dY
// phases), the stage's epilogue applied by a second launch
int gemm_filled(Kind kind, long long M, int N, long long K, Parts a, Parts b,
                const BwdEpi::Args& epi, float* part, cudaStream_t s) {
  const Split sp = split_of(M, N, K);
  if (sp.splits <= 1) return gemm(kind, M, N, K, a, b, epi, s);
  BwdEpi::Args out{};
  out.stage = kOut;
  out.f32 = part;
  if (int err = gemm(kind, M, N, K, a, b, out, s, sp)) return err;
  const long long pairs = M * N / 2, blocks = (pairs + 255) / 256;
  finish_splits<<<(int)(blocks < 2048 ? blocks : 2048), 256, 0, s>>>(part, sp.splits, M, N,
                                                                      epi);
  return (int)cudaGetLastError();
}

// out[r * ldo + c] = sum_{s < splits} part[(s * M + r) * N + c], in order,
// for r < rows, c < cols
__global__ void sum_splits(const float* __restrict__ part, int splits, long long M, int N,
                           int rows, int cols, float* __restrict__ out, int ldo) {
  const long long n = (long long)rows * cols, step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    const long long r = i / cols;
    const int c = (int)(i - r * cols);
    float v = 0.f;
    for (int sp = 0; sp < splits; ++sp) v += part[((long long)sp * M + r) * N + c];
    out[r * ldo + c] = v;
  }
}

size_t round_up(size_t v) { return (v + 1023) / 1024 * 1024; }

// the hopper route's workspace, 1024-aligned pieces; base null: only count
struct HopperWs {
  // split into three parts: phi, the weights, y, h1, h2, dY, dh2, dh1 (the
  // last six stacked over rounds) and dpw1
  Parts phi, w1p, w1y, w2, w3p, ys, h1, h2, dys, dh2, dh1, dpw1s;
  float *pw1, *y, *dy, *dysum, *dh2sum, *dpw1, *part, *cpart;
  size_t bytes;
  HopperWs(void* base, int N, int D, int H, int iters, size_t part_floats) {
    size_t off = 0;
    uint8_t* b = static_cast<uint8_t*>(base);
    auto take = [&](size_t n) {
      void* q = b != nullptr ? b + off : nullptr;
      off += round_up(n);
      return q;
    };
    auto parts = [&](size_t elems) {
      const long long half = (long long)(round_up(elems * 2) / 2);
      return Parts{static_cast<bf16*>(take(PARTS * 2 * half)), half};
    };
    const size_t n = N, nh = n * H, R = (size_t)iters * n;
    phi = parts(n * D);
    w1p = parts((size_t)D * H);
    w1y = parts((size_t)P_PAD * H);
    w2 = parts((size_t)H * H);
    w3p = parts((size_t)H * P_PAD);
    ys = parts(R * P_PAD);
    h1 = parts(R * H);
    h2 = parts(R * H);
    dys = parts(R * P_PAD);
    dh2 = parts(R * H);
    dh1 = parts(R * H);
    dpw1s = parts(nh);
    pw1 = static_cast<float*>(take(nh * 4));
    y = static_cast<float*>(take(n * P_PAD * 4));
    dy = static_cast<float*>(take(n * P_PAD * 4));
    dysum = static_cast<float*>(take(n * P_PAD * 4));
    dh2sum = static_cast<float*>(take(nh * 4));
    dpw1 = static_cast<float*>(take(nh * 4));
    part = static_cast<float*>(take(part_floats * 4));
    cpart = static_cast<float*>(take((size_t)kChunks * H * 4));
    bytes = off;
  }
};

// the weight gradients' row ranges, and the floats of their partial sums
struct WgtPlan {
  Split w1p, w1y, w2, w3;
  size_t part_floats;
};

WgtPlan wgt_plan(int N, int D, int H, int iters) {
  const long long R = (long long)iters * N;
  WgtPlan w{split_of(D, H, N), split_of(P_PAD, H, R), split_of(H, H, R), split_of(H, P_PAD, R),
            0};
  auto floats = [](Split s, long long M, int cols) { return (size_t)s.splits * M * cols; };
  size_t f = floats(w.w1p, D, H);
  f = f > floats(w.w1y, P_PAD, H) ? f : floats(w.w1y, P_PAD, H);
  f = f > floats(w.w2, H, H) ? f : floats(w.w2, H, H);
  f = f > floats(w.w3, H, P_PAD) ? f : floats(w.w3, H, P_PAD);
  // the split y and dY phases (gemm_filled): N x 64 over H
  const size_t narrow = floats(split_of(N, P_PAD, H), N, P_PAD);
  w.part_floats = f > narrow ? f : narrow;
  return w;
}

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
  H36X_TRY(colsum(s, w.dh1, R, H, H, w.part, db1));
  H36X_TRY(colsum(s, w.dh2, R, H, H, w.part, db2));
  H36X_TRY(colsum(s, w.dys, R, P, P, w.part, db3));
#undef H36X_TRY
  return (int)cudaSuccess;
}

// bytes of the hopper route's workspace (0: shapes it does not take: D or H
// not a multiple of 64, P above 64, no rows, no rounds, or too many rows)
extern "C" size_t h36x_joint_regressor_bwd_hopper_workspace(int N, int D, int H, int P,
                                                            int iters) {
  if (N <= 0 || D <= 0 || H <= 0 || D % 64 || H % 64 || P <= 0 || P > P_PAD || iters < 1)
    return 0;
  if ((long long)iters * N >= (1ll << 30)) return 0;
  return HopperWs(nullptr, N, D, H, iters, wgt_plan(N, D, H, iters).part_floats).bytes;
}

// The hopper route: as h36x_joint_regressor_bwd, with ws holding
// h36x_joint_regressor_bwd_hopper_workspace(N, D, H, P, iters) bytes,
// 1024-aligned. Returns the first launch's CUDA error, or 0.
extern "C" int h36x_joint_regressor_bwd_hopper(
    const float* phi, const float* w1, const float* b1, const float* w2, const float* b2,
    const float* w3, const float* b3, const float* g, void* ws, float* dphi, float* dw1,
    float* db1, float* dw2, float* db2, float* dw3, float* db3, int N, int D, int H, int P,
    int iters, void* stream) {
  if (h36x_joint_regressor_bwd_hopper_workspace(N, D, H, P, iters) == 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WgtPlan plan = wgt_plan(N, D, H, iters);
  const HopperWs w(ws, N, D, H, iters, plan.part_floats);
  const long long n = N, R = (long long)iters * N;
  const size_t nh = (size_t)N * H, np = (size_t)N * P_PAD;
  int err;
#define H36X_TRY(call) \
  if ((err = (call))) return err

  // -- operands split into three bf16 parts; dY = g and its sum; y_0 = 0 --
  Jobs jobs{};
  auto job = [&](const float* src, int ld, int rows, int cols, long long dst_rows, int dst_cols,
                 Parts dst, float* f32 = nullptr, float* f32b = nullptr) {
    jobs.job[jobs.n++] = Job{src, ld, rows, cols, dst_rows, dst_cols, dst.p, dst.half, f32, f32b};
  };
  job(phi, D, N, D, n, D, w.phi);
  job(w1, H, D, H, D, H, w.w1p);
  job(w1 + (size_t)D * H, H, P, H, P_PAD, H, w.w1y);
  job(w2, H, H, H, H, H, w.w2);
  job(w3, P, H, P, H, P_PAD, w.w3p);
  job(g, P, N, P, n, P_PAD, w.dys.at((iters - 1) * np), w.dy, w.dysum);
  job(nullptr, 0, 0, 0, n, P_PAD, w.ys);
  long long total = 0;
  for (int j = 0; j < jobs.n; ++j) total += jobs.job[j].rows * jobs.job[j].cols;
  const long long want = (total + 255) / 256;
  split_prologue<<<(int)(want < 2048 ? want : 2048), 256, 0, s>>>(jobs);
  H36X_TRY((int)cudaGetLastError());

  auto ys = [&](int it) { return w.ys.at(it * np); };
  auto dys = [&](int it) { return w.dys.at(it * np); };
  auto h1 = [&](int it) { return w.h1.at(it * nh); };
  auto h2 = [&](int it) { return w.h2.at(it * nh); };
  auto dh1 = [&](int it) { return w.dh1.at(it * nh); };
  auto dh2 = [&](int it) { return w.dh2.at(it * nh); };
  auto args = [&](int stage, int first, const float* bias, float* f32, Parts out,
                  float* f32b = nullptr, const bf16* mask = nullptr) {
    return BwdEpi::Args{stage, first, P, bias, f32, f32b, mask, out.p, out.half, nullptr, 0};
  };

  // -- the forward, recomputed: pw1 (and h1_0), then [h1,] h2[, y] a round --
  H36X_TRY(gemm(kFwd, n, H, D, w.phi, w.w1p, args(kPw1, 0, b1, w.pw1, h1(0)), s));
  for (int it = 0; it < iters; ++it) {
    if (it > 0)
      H36X_TRY(gemm(kFwd, n, H, P_PAD, ys(it), w.w1y, args(kH1, 0, b1, w.pw1, h1(it)), s));
    H36X_TRY(gemm(kFwd, n, H, H, h1(it), w.w2, args(kH2, 0, b2, nullptr, h2(it)), s));
    if (it + 1 < iters)
      H36X_TRY(gemm_filled(kFwd, n, P_PAD, H, h2(it), w.w3p,
                           args(kY, it == 0, b3, w.y, ys(it + 1)), w.part, s));
  }
  // -- the backward through the unrolled loop, the last round first --------
  for (int it = iters - 1; it >= 0; --it) {
    const int first = it == iters - 1;
    H36X_TRY(gemm(kBwd, n, H, P_PAD, dys(it), w.w3p,
                  args(kDh2, first, nullptr, w.dh2sum, dh2(it), nullptr, h2(it).p), s));
    BwdEpi::Args e = args(kDh1, first, nullptr, w.dpw1, dh1(it), nullptr, h1(it).p);
    if (it == 0) {
      e.out2 = w.dpw1s.p;
      e.half2 = w.dpw1s.half;
    }
    H36X_TRY(gemm(kBwd, n, H, H, dh2(it), w.w2, e, s));
    if (it > 0)
      H36X_TRY(gemm_filled(kBwd, n, P_PAD, H, dh1(it), w.w1y,
                           args(kDy, 0, nullptr, w.dy, dys(it - 1), w.dysum), w.part, s));
  }
  H36X_TRY(gemm(kBwd, n, D, H, w.dpw1s, w.w1p, args(kOut, 0, nullptr, dphi, Parts{}), s));

  // -- weight gradients over the stacked rows, partial sums added in order --
  auto wgt = [&](long long M, int cols, long long rows, Parts a, Parts b, Split sp, int out_rows,
                 int out_cols, float* dst, int ldo) {
    int e = gemm(kWgt, M, cols, rows, a, b, args(kOut, 0, nullptr, w.part, Parts{}), s, sp);
    if (e) return e;
    const long long cnt = (long long)out_rows * out_cols, blocks = (cnt + 255) / 256;
    sum_splits<<<(int)(blocks < 2048 ? blocks : 2048), 256, 0, s>>>(
        w.part, sp.splits, M, cols, out_rows, out_cols, dst, ldo);
    return (int)cudaGetLastError();
  };
  H36X_TRY(wgt(D, H, n, w.phi, w.dpw1s, plan.w1p, D, H, dw1, H));
  H36X_TRY(wgt(P_PAD, H, R, w.ys, w.dh1, plan.w1y, P, H, dw1 + (size_t)D * H, H));
  H36X_TRY(wgt(H, H, R, w.h1, w.dh2, plan.w2, H, H, dw2, H));
  H36X_TRY(wgt(H, P_PAD, R, w.h2, w.dys, plan.w3, H, P, dw3, P));

  // -- bias gradients: column sums of the f32 sums over rounds -------------
  H36X_TRY((int)colsum(s, w.dpw1, N, H, H, w.cpart, db1));
  H36X_TRY((int)colsum(s, w.dh2sum, N, H, H, w.cpart, db2));
  H36X_TRY((int)colsum(s, w.dysum, N, P, P_PAD, w.cpart, db3));
#undef H36X_TRY
  return 0;
}
