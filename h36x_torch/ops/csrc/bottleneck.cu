// Fused ResNet bottleneck block (inference, BatchNorm folded), sm_90a.
//
// Replaces the Pallas TPU kernel h36x/ops/pallas_bottleneck.py::_kernel
// (reached through fused_bottleneck / resnet50_fused_forward, and in the
// port through the `opt` extraction engine's 13 stride-1 blocks):
//
//   a   = relu(x @ W1 + b1)                        rounded to T
//   b   = relu(conv3x3_SAME(a; W2) + b2)           rounded to T
//   out = relu(b @ W3 + b3 + res)                  rounded to T once
//   res = x (upcast to f32)  |  x @ Wp + bp  (projection blocks)
//
// x, out and the workspaces are (B*H*W, C) rows in T (bfloat16 on the
// extraction path, float32 in the checks); a channels_last NCHW tensor has
// exactly this memory order. Weights arrive folded in f32 and cast to T by
// the wrapper, biases stay f32, every product accumulates in f32: the
// rounding points of the TPU kernel.
//
// What bounds it on the H100: at the stage shapes the block does about
// 437 MFLOP per frame (bf16 tensor-core peak 989 TFLOP/s) against 0.4 to
// 3.2 MB of input plus output per frame (3.35 TB/s), so the 56x56 blocks
// are bound by bytes and the 7x7 ones by operations.
//
// Two routes, chosen by the wrapper from the dtype and the widths alone
// (h36x_torch/ops/bottleneck.py::bottleneck_route):
//
// The Hopper route (bfloat16, C_in, C_mid and C_out multiples of 64: all 13
// stride-1 blocks of ResNet-50). Three launches of hopper.cuh's
// warp-specialised persistent TMA + wgmma GEMM with two workspaces between
// them: (1) a = x @ W1; (2) b = the 3x3 conv as an implicit GEMM of depth
// 9*C_mid, whose A tile a producer warpgroup fills with 16-byte cp.async,
// zero-filled outside the image (the pixel of each row and its 9 taps'
// validity found once per tile; a 64-channel K stage lies within one tap);
// (3) [b | x] @ [W3; Wp] (two K segments, switching at C_mid along
// K) or b @ W3 with the identity residual in the epilogue. A loads by TMA
// K-major and the weights as they lie, (K, N) row-major, MN-major through
// wgmma's transpose bit, both with 128-byte swizzle. BN is the widest of
// 256, 128, 64 that divides the launch's N. The epilogue adds the bias and the residual in
// f32 from the registers, applies the ReLU, rounds once and stores 16 bytes
// a thread through shared memory.
//
// The general route (float32, the fp32-accuracy mode, and widths that are no
// multiple of 64): the first design, right and simple, not fast. The same
// three launches of one templated GEMM: 128 threads own a 64 x 64 output tile
// and walk the reduction 32 deep, double-buffered through shared memory (the
// next tile's global loads are in flight while the current one multiplies).
// The 3x3's A-tile loader reads the tap's shifted pixel of `a` with a
// predicate that yields 0 outside the image (this replaces the TPU kernel's
// halo blocks, strips and iota masks: every image edge is a bounds test on
// the pixel, so any H, W >= 1 works); a projection block concatenates
// [b | x] along the reduction and stacks [W3; Wp] (the wrapper adds bp into
// b3), so c + res comes out of one f32 accumulator. bfloat16 runs on the
// tensor cores (mma.sync m16n8k16, f32 accumulators, four warps of 32 x 32);
// float32 on the FMA pipes (8 x 4 outputs a thread). Global loads are 16
// bytes a thread where every width and pointer allows it, else one element.
// (The FP32 tile of gemm_tile.cuh does not fit here: its A layout is k-major
// and it has no tensor-core path.)
//
// On both routes `a` and `b` make one round trip through device memory each,
// about 0.5x the bytes of x + out at 56x56; the forward as a whole is bound
// by operations, so that is second-order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32, NT = 128;

enum Mode { kPlain = 0, kIm2col = 1, kConcat = 2 };

struct GemmArgs {
  const void* a;      // A rows: (M, lda)
  const void* a2;     // kConcat: A columns k >= k1 come from these rows (M, lda2)
  const void* w;      // B: (K, N) row-major
  const float* bias;  // (N,) f32
  const void* res;    // (M, N) identity residual, or nullptr
  void* out;          // (M, N)
  long long M;
  int N, K;
  int lda, lda2, k1;
  int H, W;           // kIm2col: image size; a holds lda = C channels, K = 9*C
};

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V consecutive elements, moved as one 16-byte access when V * sizeof(T) == 16
template <typename T, int V>
struct alignas(sizeof(T) * V) Chunk {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Chunk<T, V> zero_chunk() {
  Chunk<T, V> c;
#pragma unroll
  for (int j = 0; j < V; ++j) c.v[j] = from_f<T>(0.f);
  return c;
}

// A[m][k .. k+V) of the GEMM, for each way of forming A. With V > 1 the host
// guarantees that a chunk never straddles K, a tap or the concat seam.
template <typename T, int MODE, int V>
__device__ __forceinline__ Chunk<T, V> load_a(const GemmArgs& p, long long m, int k) {
  using C = Chunk<T, V>;
  if (m >= p.M || k >= p.K) return zero_chunk<T, V>();
  const T* src;
  if constexpr (MODE == kPlain) {
    src = static_cast<const T*>(p.a) + m * p.lda + k;
  } else if constexpr (MODE == kConcat) {
    src = k < p.k1 ? static_cast<const T*>(p.a) + m * p.lda + k
                   : static_cast<const T*>(p.a2) + m * p.lda2 + (k - p.k1);
  } else {  // kIm2col: tap (dy, dx) of output pixel m, zero outside the image
    const int c = p.lda;
    const int tap = k / c;
    const int ch = k - tap * c;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const long long hw = (long long)p.H * p.W;
    const int pix = (int)(m % hw);
    const int y = pix / p.W, x = pix - (pix / p.W) * p.W;
    if (y + dy < 0 || y + dy >= p.H || x + dx < 0 || x + dx >= p.W)
      return zero_chunk<T, V>();
    src = static_cast<const T*>(p.a) + (m + (long long)dy * p.W + dx) * c + ch;
  }
  return *reinterpret_cast<const C*>(src);
}

template <typename T, int V>
__device__ __forceinline__ Chunk<T, V> load_b(const GemmArgs& p, int k, int n) {
  if (k >= p.K || n >= p.N) return zero_chunk<T, V>();
  return *reinterpret_cast<const Chunk<T, V>*>(static_cast<const T*>(p.w) +
                                                (long long)k * p.N + n);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T, int MODE, bool VEC>
__global__ void __launch_bounds__(NT) gemm_kernel(const GemmArgs p) {
  constexpr int V = VEC ? 16 / (int)sizeof(T) : 1;
  constexpr int LD = BK + 16 / (int)sizeof(T);  // row pitch: 16-byte aligned rows
  constexpr int A_CH = BM * BK / V / NT;        // A chunks a thread moves per tile
  constexpr int B_CH = BK * BN / V / NT;
  using C = Chunk<T, V>;
  __shared__ __align__(16) T As[2][BM][LD];  // As[m][k]
  __shared__ __align__(16) T Bs[2][BN][LD];  // Bs[n][k]: B transposed

  const int tid = threadIdx.x;
  const int n_tiles = (p.N + BN - 1) / BN;
  // the n tile varies fastest: blocks in flight together share their A rows
  const long long m0 = (long long)(blockIdx.x / n_tiles) * BM;
  const int n0 = (int)(blockIdx.x % n_tiles) * BN;
  const int nk = (p.K + BK - 1) / BK;

  C ra[A_CH], rb[B_CH];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_CH; ++i) {
      const int id = tid + i * NT;
      const int row = id / (BK / V), kc = (id % (BK / V)) * V;
      ra[i] = load_a<T, MODE, V>(p, m0 + row, k0 + kc);
    }
#pragma unroll
    for (int i = 0; i < B_CH; ++i) {
      const int id = tid + i * NT;
      const int kk = id / (BN / V), nn = (id % (BN / V)) * V;
      rb[i] = load_b<T, V>(p, k0 + kk, n0 + nn);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_CH; ++i) {
      const int id = tid + i * NT;
      const int row = id / (BK / V), kc = (id % (BK / V)) * V;
      *reinterpret_cast<C*>(&As[buf][row][kc]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_CH; ++i) {
      const int id = tid + i * NT;
      const int kk = id / (BN / V), nn = (id % (BN / V)) * V;
#pragma unroll
      for (int j = 0; j < V; ++j) Bs[buf][nn + j][kk] = rb[i].v[j];
    }
  };

  // bf16: acc[i][j] is the fragment of m-tile i, n-tile j; f32: output
  // (ty + 8r, tx + 16c) sits at acc[r / 4][r % 4][c]
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;       // mma fragment coordinates
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int tx = tid & 15, ty = tid >> 4;       // FMA: rows ty + 8i, cols tx + 16j

  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) fetch((kt + 1) * BK);
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        uint32_t af[2][4], bf[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = wm + i * 16 + g;
          af[i][0] = *reinterpret_cast<const uint32_t*>(&As[cur][r][ks + 2 * t4]);
          af[i][1] = *reinterpret_cast<const uint32_t*>(&As[cur][r + 8][ks + 2 * t4]);
          af[i][2] = *reinterpret_cast<const uint32_t*>(&As[cur][r][ks + 2 * t4 + 8]);
          af[i][3] = *reinterpret_cast<const uint32_t*>(&As[cur][r + 8][ks + 2 * t4 + 8]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = wn + j * 8 + g;
          bf[j][0] = *reinterpret_cast<const uint32_t*>(&Bs[cur][c][ks + 2 * t4]);
          bf[j][1] = *reinterpret_cast<const uint32_t*>(&Bs[cur][c][ks + 2 * t4 + 8]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(acc[i][j], af[i], bf[j]);
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < BK; ++k) {
        float a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = to_f<T>(As[cur][ty + 8 * i][k]);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = to_f<T>(Bs[cur][tx + 16 * j][k]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i / 4][i % 4][j] = fmaf(a[i], b[j], acc[i / 4][i % 4][j]);
      }
    }
    if (kt + 1 < nk) stash(cur ^ 1);
    __syncthreads();
  }

  T* out = static_cast<T*>(p.out);
  const T* res = static_cast<const T*>(p.res);
  auto emit = [&](int ml, int nl, float v) {
    const long long m = m0 + ml;
    const int n = n0 + nl;
    if (m >= p.M || n >= p.N) return;
    v += p.bias[n];
    if (res != nullptr) v += to_f<T>(res[m * p.N + n]);
    out[m * p.N + n] = from_f<T>(fmaxf(v, 0.f));
  };
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* d = acc[i][j];
        const int r = wm + i * 16 + g, c = wn + j * 8 + 2 * t4;
        emit(r, c, d[0]);
        emit(r, c + 1, d[1]);
        emit(r + 8, c, d[2]);
        emit(r + 8, c + 1, d[3]);
      }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) emit(ty + 8 * i, tx + 16 * j, acc[i / 4][i % 4][j]);
  }
}

bool aligned16(const void* ptr) { return ptr == nullptr || (uintptr_t)ptr % 16 == 0; }

template <typename T>
int launch(const GemmArgs& p, int mode, cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(T);
  // 16-byte chunks need every width the loaders step by to be a multiple of
  // V (so that no chunk straddles a row, tap or seam) and aligned pointers
  bool vec = p.K % V == 0 && p.N % V == 0 && p.lda % V == 0 &&
             aligned16(p.a) && aligned16(p.w);
  if (mode == kConcat) vec = vec && p.lda2 % V == 0 && p.k1 % V == 0 && aligned16(p.a2);
  const long long blocks = ((p.M + BM - 1) / BM) * (long long)((p.N + BN - 1) / BN);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  // an empty batch gives a grid of 0 blocks: the launch is refused and
  // cudaGetLastError below reports (and clears) it
  const dim3 grid((unsigned)blocks);
#define H36X_LAUNCH(M_, V_) gemm_kernel<T, M_, V_><<<grid, NT, 0, stream>>>(p)
  if (mode == kPlain) {
    if (vec) H36X_LAUNCH(kPlain, true); else H36X_LAUNCH(kPlain, false);
  } else if (mode == kIm2col) {
    if (vec) H36X_LAUNCH(kIm2col, true); else H36X_LAUNCH(kIm2col, false);
  } else {
    if (vec) H36X_LAUNCH(kConcat, true); else H36X_LAUNCH(kConcat, false);
  }
#undef H36X_LAUNCH
  return (int)cudaGetLastError();
}

template <typename T>
int block_forward(const void* x, const void* w1, const float* b1, const void* w2,
                  const float* b2, const void* w3p, const float* b3p, void* a_ws,
                  void* b_ws, void* out, int B, int H, int W, int c_in, int c_mid,
                  int c_out, int has_proj, cudaStream_t stream) {
  const long long M = (long long)B * H * W;
  GemmArgs p{};
  p.M = M;
  p.H = H;
  p.W = W;
  // (1) a = relu(x @ W1 + b1)
  p.a = x; p.lda = c_in; p.K = c_in; p.N = c_mid;
  p.w = w1; p.bias = b1; p.res = nullptr; p.out = a_ws;
  int err = launch<T>(p, kPlain, stream);
  if (err) return err;
  // (2) b = relu(conv3x3_SAME(a) + b2), an implicit GEMM of depth 9*C_mid
  p.a = a_ws; p.lda = c_mid; p.K = 9 * c_mid; p.N = c_mid;
  p.w = w2; p.bias = b2; p.out = b_ws;
  err = launch<T>(p, kIm2col, stream);
  if (err) return err;
  // (3) out = relu(b @ W3 + b3 + res)
  p.a = b_ws; p.lda = c_mid; p.N = c_out; p.w = w3p; p.bias = b3p; p.out = out;
  if (has_proj) {  // [b | x] @ [W3; Wp] + (b3 + bp)
    p.a2 = x; p.lda2 = c_in; p.k1 = c_mid; p.K = c_mid + c_in;
    return launch<T>(p, kConcat, stream);
  }
  p.K = c_mid;
  p.res = x;
  return launch<T>(p, kPlain, stream);
}

// ---- the Hopper route ----------------------------------------------------------

namespace hp = h36x_hopper;

// relu(acc + bias [+ res]) rounded to bf16, stored 16 bytes a thread
struct BiasResRelu {
  struct Args {
    const float* bias;           // (N,)
    const __nv_bfloat16* res;    // (M, N) identity residual, or nullptr
    __nv_bfloat16* out;          // (M, N)
  };
  template <int BN>
  static constexpr int bytes() {
    return hp::staging_bytes<BN>();
  }
  template <int BN>
  __device__ static void store(float (&d)[BN / 2], const Args& a, long long M, int N,
                               long long m0, int n0, uint8_t* stage, int wg, int tid) {
    hp::store_tile_bf16<BN>(d, a.out, M, N, m0, n0, stage, wg, tid,
                            [&](int r, int c, float v0, float v1) {
                              const long long m = m0 + r;
                              const int n = n0 + c;
                              const float2 b = *reinterpret_cast<const float2*>(a.bias + n);
                              v0 += b.x;
                              v1 += b.y;
                              if (a.res != nullptr && m < M) {
                                const __nv_bfloat162 x = *reinterpret_cast<
                                    const __nv_bfloat162*>(a.res + m * N + n);
                                v0 += __low2float(x);
                                v1 += __high2float(x);
                              }
                              return __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
                            });
  }
};

template <int BN, bool IM2COL>
using BlockGemm = hp::Gemm<__nv_bfloat16, BN, true, IM2COL, BiasResRelu>;
using HopperParams = hp::Params<BiasResRelu>;

int map_rows(CUtensorMap* map, const void* base, long long rows, int cols, int box_rows) {
  return hp::make_map(map, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, cols, rows, 2ull * cols, 64,
                      box_rows);
}

// one GEMM of the block: out = relu(A @ w + bias [+ res]); w (K, N)
template <bool IM2COL>
int hopper_gemm(HopperParams p, const void* w, cudaStream_t stream) {
  const int bn = p.N % 256 == 0 ? 256 : p.N % 128 == 0 ? 128 : 64;
  if (!hp::fits<BlockGemm<64, IM2COL>>(p)) return (int)cudaErrorInvalidValue;
  const int err = map_rows(&p.b[0], w, p.K, p.N, 64);
  if (err) return err;
  switch (bn) {
    case 256: return hp::launch_gemm<BlockGemm<256, IM2COL>>(p, stream);
    case 128: return hp::launch_gemm<BlockGemm<128, IM2COL>>(p, stream);
    default: return hp::launch_gemm<BlockGemm<64, IM2COL>>(p, stream);
  }
}

int block_forward_hopper(const void* x, const void* w1, const float* b1, const void* w2,
                         const float* b2, const void* w3p, const float* b3p, void* a_ws,
                         void* b_ws, void* out, int B, int H, int W, int c_in, int c_mid,
                         int c_out, int has_proj, cudaStream_t stream) {
  const long long M = (long long)B * H * W;
  // an empty batch is refused, as a grid of 0 blocks is on the general route
  if (M <= 0) return (int)cudaErrorInvalidConfiguration;
  if (M >= INT_MAX / 2 || c_in % 64 || c_mid % 64 || c_out % 64) return (int)cudaErrorInvalidValue;
  HopperParams p{};
  p.M = M;
  // (1) a = relu(x @ W1 + b1)
  int err = map_rows(&p.a[0], x, M, c_in, hp::BM);
  if (err) return err;
  p.N = c_mid;
  hp::add_seg(p, 0, 0, c_in);
  p.epi = {b1, nullptr, static_cast<__nv_bfloat16*>(a_ws)};
  if ((err = hopper_gemm<false>(p, w1, stream))) return err;
  // (2) b = relu(conv3x3_SAME(a) + b2), an implicit GEMM of depth 9*C_mid
  p.im = {static_cast<const __nv_bfloat16*>(a_ws), c_mid, H, W};
  p.K = p.segs = 0;
  hp::add_seg(p, 0, 0, 9 * c_mid);
  p.epi = {b2, nullptr, static_cast<__nv_bfloat16*>(b_ws)};
  if ((err = hopper_gemm<true>(p, w2, stream))) return err;
  // (3) out = relu(b @ W3 + b3 + x) or relu([b | x] @ [W3; Wp] + (b3 + bp))
  if ((err = map_rows(&p.a[0], b_ws, M, c_mid, hp::BM))) return err;
  p.N = c_out;
  p.K = p.segs = 0;
  hp::add_seg(p, 0, 0, c_mid);
  if (has_proj) {
    // [b | x] @ [W3; Wp]: x against W3p's rows c_mid ..
    if ((err = map_rows(&p.a[1], x, M, c_in, hp::BM))) return err;
    hp::add_seg(p, 1, 0, c_in, c_mid);
    p.epi = {b3p, nullptr, static_cast<__nv_bfloat16*>(out)};
  } else {
    p.epi = {b3p, static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out)};
  }
  return hopper_gemm<false>(p, w3p, stream);
}

}  // namespace

// route: 0 general (dtype 0 float32 or 1 bfloat16, any widths), 1 Hopper
// (bfloat16, C_in, C_mid, C_out multiples of 64). w1 (C_in, C_mid), w2
// (9*C_mid, C_mid) in (dy, dx, c_in) row order, w3p (C_mid [+ C_in], C_out),
// all T, row-major; b1, b2, b3p f32. a_ws and b_ws hold (B*H*W, C_mid) T
// each. Every pointer 16-byte aligned on the Hopper route. Returns the
// first launch's CUDA error, or 0.
extern "C" int h36x_fused_bottleneck(const void* x, const void* w1, const float* b1,
                                     const void* w2, const float* b2, const void* w3p,
                                     const float* b3p, void* a_ws, void* b_ws, void* out,
                                     int B, int H, int W, int c_in, int c_mid, int c_out,
                                     int has_proj, int dtype, int route, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return block_forward_hopper(x, w1, b1, w2, b2, w3p, b3p, a_ws, b_ws, out, B, H, W, c_in,
                                c_mid, c_out, has_proj, s);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return block_forward<__nv_bfloat16>(x, w1, b1, w2, b2, w3p, b3p, a_ws, b_ws, out, B,
                                        H, W, c_in, c_mid, c_out, has_proj, s);
  if (dtype == 0)
    return block_forward<float>(x, w1, b1, w2, b2, w3p, b3p, a_ws, b_ws, out, B, H, W,
                                c_in, c_mid, c_out, has_proj, s);
  return (int)cudaErrorInvalidValue;
}
