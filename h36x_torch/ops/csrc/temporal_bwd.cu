// Backward of the fused GroupNorm -> ReLU -> K-tap causal conv, sm_90a.
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
// outputs: 0.016 ms at the bf16 peak with the products counted once, 0.098
// ms for the six passes of the bf16 split, 0.241 ms at the FP32 peak.
//
// Two routes, chosen by the wrapper from the shapes alone
// (h36x_torch/ops/temporal.py::temporal_bwd_route); neither uses atomics,
// so every sum has one fixed order and a step is reproducible bit for bit.
//
// The hopper route (D and O multiples of 64), float32 accuracy on the
// tensor cores: each float32 operand is split into three bf16 parts (v0 =
// bf16(v), v1 = bf16(v - v0), v2 = bf16(v - v0 - v1), from the float32
// value) and every product is the six passes a_i.b_j with i + j < 3, summed
// in f32 by hopper.cuh's TMA + wgmma GEMM, the passes as six K segments
// (hopper.cuh's split_passes), every four K stages' products added from the
// wgmma accumulator into a separate f32 sum (hopper.cuh's PROMOTE).
// h36x's _dot32(precise=True) takes three passes of two parts; at the
// training shape their ~2^-18 per product misses the element-wise gradient
// tolerance, the six passes' ~2^-27 sits below float32's own rounding, and
// without the promotion the tensor cores' accumulation over the 18432 K
// columns drifts from the float32 result, one way (PERF.md). Five launches:
//   1. bwd_prologue writes the GEMMs' operands split into three parts:
//      the shifted output gradient G (B*T, K*O), tap k's columns holding
//      Gk (its row 0 the f32 sum of the sample's rows 0..s_k, no row
//      reading across samples); W as (D, K*O), dr's K-major B; r's K tap-shifted
//      copies (B*T, K*D), each clamped to row 0 of its own sample,
//      recomputed from x and the forward's statistics.
//   2. dr: (B*T) x D over K = 6 x K*O; its epilogue recomputes a and stores
//      da = dr * (a > 0) in f32.
//   3-4. gn_bwd and param_reduce as on the general route (f32, memory-bound).
//   5. dW: (K*D) x O over K = 6 x B*T rows, all inside one tile: A is the
//      shifted r read MN-major as it lies (wgmma's transpose bit), B the
//      unshifted tap of G (which is g) read MN-major; B*T rows that are no
//      multiple of 64 are padded by TMA's zero fill past the tensor.
//
// The general route (any widths: the first design, FP32 on the CUDA cores),
// four launches:
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_tile.cuh"
#include "hopper.cuh"

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

// ---- the hopper route ---------------------------------------------------------

namespace hp = h36x_hopper;
using bf16 = __nv_bfloat16;

constexpr int kPrologueThreads = 256;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// four neighbouring values split into three bf16 parts, `half` elements apart
__device__ __forceinline__ void store4(bf16* parts, long long half, long long off, float4 v) {
  hp::store_split3(parts, half, off, v.x, v.y);
  hp::store_split3(parts, half, off + 2, v.z, v.w);
}

// One launch, three regions of blocks (each grid-strides over its quads of
// 4 columns): blocks [0, gb) write G (B*T, K*O), [gb, gb + wb) write W
// (D, K*O), the rest r's taps (B*T, K*D); each split into three bf16 parts
// (the parts of G lie g_half elements apart, of W w_half, of r r_half)
__global__ void __launch_bounds__(kPrologueThreads)
bwd_prologue(const float* __restrict__ x, const float* __restrict__ scale,
             const float* __restrict__ bias, const float* __restrict__ w,
             const float* __restrict__ g, const float* __restrict__ mean,
             const float* __restrict__ rstd, bf16* __restrict__ gp, long long g_half,
             bf16* __restrict__ wp, long long w_half, bf16* __restrict__ rp, long long r_half,
             int B, int T, int D, int O, int K, int G, int gb, int wb) {
  const long long KO = (long long)K * O, KD = (long long)K * D, bt = (long long)B * T;
  const int blk = blockIdx.x;
  if (blk < gb) {
    const long long q = KO / 4, n = bt * q, step = (long long)gb * blockDim.x;
    for (long long i = (long long)blk * blockDim.x + threadIdx.x; i < n; i += step) {
      const long long row = i / q;
      const int col = (int)(i - row * q) * 4;
      const int b = (int)(row / T), j = (int)(row - (long long)b * T);
      const int k = col / O, o = col - k * O, sft = K - 1 - k;
      const float* gs = g + (long long)b * T * O + o;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j == 0) {
        // the replicated edge: rows 0 .. s_k of this sample, summed in order
        const int last = min(sft, T - 1);
        for (int t = 0; t <= last; ++t) {
          const float4 u = ld4(gs + (long long)t * O);
          v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
        }
      } else if (j + sft < T) {
        v = ld4(gs + (long long)(j + sft) * O);
      }
      store4(gp, g_half, row * KO + col, v);
    }
  } else if (blk < gb + wb) {
    const long long q = KO / 4, n = (long long)D * q, step = (long long)wb * blockDim.x;
    for (long long i = (long long)(blk - gb) * blockDim.x + threadIdx.x; i < n; i += step) {
      const int d = (int)(i / q), col = (int)(i - (long long)d * q) * 4;
      const int k = col / O, o = col - k * O;
      store4(wp, w_half, (long long)d * KO + col, ld4(w + ((long long)k * D + d) * O + o));
    }
  } else {
    const int rb = gridDim.x - gb - wb, gs = D / G;
    const long long q = KD / 4, n = bt * q, step = (long long)rb * blockDim.x;
    for (long long i = (long long)(blk - gb - wb) * blockDim.x + threadIdx.x; i < n;
         i += step) {
      const long long row = i / q;
      const int col = (int)(i - row * q) * 4;
      const int b = (int)(row / T), t = (int)(row - (long long)b * T);
      const int k = col / D, c = col - k * D;
      const int src = max(t - (K - 1 - k), 0);
      const float4 xv = ld4(x + ((long long)b * T + src) * D + c);
      float v[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gi = b * G + (c + e) / gs;
        v[e] = fmaxf((v[e] - mean[gi]) * rstd[gi] * scale[c + e] + bias[c + e], 0.f);
      }
      store4(rp, r_half, row * KD + col, make_float4(v[0], v[1], v[2], v[3]));
    }
  }
}

// da = acc * (a > 0), a recomputed from x and the forward's statistics as
// dr_gemm's epilogue does, f32 straight from the accumulators
struct DaEpi {
  struct Args {
    const float *x, *scale, *bias, *mean, *rstd;
    float* da;
    int T, G, gs;
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
      const int b = (int)(m / a.T);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * (lane & 3);
        const long long off = m * N + n;
        const float2 xv = *reinterpret_cast<const float2*>(a.x + off);
        const int g0 = b * a.G + n / a.gs, g1 = b * a.G + (n + 1) / a.gs;
        const float a0 = (xv.x - a.mean[g0]) * a.rstd[g0] * a.scale[n] + a.bias[n];
        const float a1 = (xv.y - a.mean[g1]) * a.rstd[g1] * a.scale[n + 1] + a.bias[n + 1];
        *reinterpret_cast<float2*>(a.da + off) =
            make_float2(a0 > 0.f ? d[4 * j + 2 * i] : 0.f,
                        a1 > 0.f ? d[4 * j + 2 * i + 1] : 0.f);
      }
    }
  }
};

constexpr int PARTS = 3;  // bf16 parts of each float32 operand
constexpr int PROMOTE_STAGES = 4;  // K stages a promoted accumulator takes (hopper.cuh)

// dr: A = G (B*T, K*O) K-major, B = W (D, K*O) K-major
template <int BN>
using DrGemm = hp::Gemm<bf16, BN, false, false, DaEpi, false, PARTS, PROMOTE_STAGES>;
// dW: A = r's taps (B*T, K*D) MN-major, B = g (B*T, O) MN-major
template <int BN>
using DwGemm = hp::Gemm<bf16, BN, true, false, hp::StoreF32, true, PARTS, PROMOTE_STAGES>;

size_t round_up(size_t v) { return (v + 1023) / 1024 * 1024; }

struct HopperPlan {
  size_t g, w, r;  // elements of each part of G, W and r's taps (1024-byte multiples)
  size_t total() const { return PARTS * 2 * (g + w + r); }
};

HopperPlan hopper_plan(int B, int T, int D, int O, int K) {
  const size_t bt = (size_t)B * T;
  return {round_up(bt * K * O * 2) / 2, round_up((size_t)D * K * O * 2) / 2,
          round_up(bt * K * D * 2) / 2};
}

const auto BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

template <int BN>
int dr_gemm_hopper(const bf16* gp, size_t g_half, const bf16* wp, size_t w_half, long long bt,
                   int D, int KO, DaEpi::Args epi, cudaStream_t s) {
  typename DrGemm<BN>::P p{};
  int err = 0;
  for (int i = 0; i < PARTS && !err; ++i) {
    err = hp::make_map(&p.a[i], gp + i * g_half, BF16, KO, bt, 2ull * KO, 64, hp::BM);
    if (!err) err = hp::make_map(&p.b[i], wp + i * w_half, BF16, KO, D, 2ull * KO, 64, BN);
  }
  if (err) return err;
  p.M = bt;
  p.N = D;
  hp::split_passes(p, PARTS, KO);
  p.epi = epi;
  if (!hp::fits<DrGemm<BN>>(p)) return (int)cudaErrorInvalidValue;
  return hp::launch_gemm<DrGemm<BN>>(p, s);
}

// g is tap K-1 of G: the columns (K-1)*O .. of each row, rows K*O apart
template <int BN>
int dw_gemm_hopper(const bf16* rp, size_t r_half, const bf16* gp, size_t g_half, long long bt,
                   int KD, int O, int KO, float* dw, cudaStream_t s) {
  typename DwGemm<BN>::P p{};
  const long long tap = KO - O;
  int err = 0;
  for (int i = 0; i < PARTS && !err; ++i) {
    err = hp::make_map(&p.a[i], rp + i * r_half, BF16, KD, bt, 2ull * KD, 64, 64);
    if (!err)
      err = hp::make_map(&p.b[i], gp + i * g_half + tap, BF16, O, bt, 2ull * KO, 64, 64);
  }
  if (err) return err;
  p.M = KD;
  p.N = O;
  hp::split_passes(p, PARTS, (int)((bt + 63) / 64 * 64));  // rows past B*T read as zeros
  p.epi = {dw};
  if (!hp::fits<DwGemm<BN>>(p)) return (int)cudaErrorInvalidValue;
  return hp::launch_gemm<DwGemm<BN>>(p, s);
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

// bytes of the hopper route's workspace (0: shapes it does not take: D or O
// not a multiple of 64, or an empty or too large batch)
extern "C" size_t h36x_gn_relu_cconv_bwd_hopper_workspace(int B, int T, int D, int O, int K) {
  if (B <= 0 || T <= 0 || K <= 0 || D <= 0 || O <= 0 || D % 64 || O % 64) return 0;
  if ((long long)B * T >= (1ll << 30) || (long long)K * (D > O ? D : O) >= (1ll << 30)) return 0;
  return hopper_plan(B, T, D, O, K).total();
}

// The hopper route: as h36x_gn_relu_cconv_bwd, with ws holding
// h36x_gn_relu_cconv_bwd_hopper_workspace(B, T, D, O, K) bytes, 1024-aligned.
// Returns the first launch's CUDA error, or 0.
extern "C" int h36x_gn_relu_cconv_bwd_hopper(const float* x, const float* scale,
                                             const float* bias, const float* w, const float* g,
                                             const float* mean, const float* rstd, void* ws,
                                             float* da, float* part, float* dx, float* dw,
                                             float* dscale, float* dbias, int B, int T, int D,
                                             int O, int K, int G, void* stream) {
  if (h36x_gn_relu_cconv_bwd_hopper_workspace(B, T, D, O, K) == 0 || G <= 0 || D % G)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const HopperPlan plan = hopper_plan(B, T, D, O, K);
  bf16* gp = static_cast<bf16*>(ws);
  bf16* wp = gp + PARTS * plan.g;
  bf16* rp = wp + PARTS * plan.w;
  const long long bt = (long long)B * T;
  const int KO = K * O, KD = K * D;

  // the three regions' blocks in proportion to their elements
  auto blocks = [](long long elems) {
    const long long b = (elems / 4 + 4 * kPrologueThreads - 1) / (4 * kPrologueThreads);
    return (int)(b < 1 ? 1 : b > 1024 ? 1024 : b);
  };
  const int gb = blocks(bt * KO), wb = blocks((long long)D * KO), rb = blocks(bt * KD);
  bwd_prologue<<<gb + wb + rb, kPrologueThreads, 0, s>>>(x, scale, bias, w, g, mean, rstd, gp,
                                                        plan.g, wp, plan.w, rp, plan.r, B, T, D,
                                                        O, K, G, gb, wb);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const DaEpi::Args epi{x, scale, bias, mean, rstd, da, T, G, D / G};
  err = D % 128 == 0 ? dr_gemm_hopper<128>(gp, plan.g, wp, plan.w, bt, D, KO, epi, s)
                     : dr_gemm_hopper<64>(gp, plan.g, wp, plan.w, bt, D, KO, epi, s);
  if (err) return err;
  gn_bwd<<<dim3(G, B), kRedThreads, 0, s>>>(x, scale, da, mean, rstd, dx, part, B, T, D, G);
  if ((err = (int)cudaGetLastError())) return err;
  param_reduce<<<cdiv(D, kRedThreads), kRedThreads, 0, s>>>(part, dscale, dbias, B, D);
  if ((err = (int)cudaGetLastError())) return err;
  return O % 128 == 0 ? dw_gemm_hopper<128>(rp, plan.r, gp, plan.g, bt, KD, O, KO, dw, s)
                      : dw_gemm_hopper<64>(rp, plan.r, gp, plan.g, bt, KD, O, KO, dw, s);
}
