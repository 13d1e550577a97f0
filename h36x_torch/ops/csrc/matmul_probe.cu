// Tiled tensor-core matmul probe, bf16 and int8, sm_90a.
//
// Replaces the Pallas TPU kernel benchmarks/int8_pallas_probe.py::_matmul_kernel
// (reached through make_pallas_matmul / bench / main): out = x (M, K) . y (K, N),
// both row-major, in two modes on one skeleton:
//
//   bf16 x bf16 -> f32 accumulator -> bf16 store (round to nearest even)
//   int8 x int8 -> int32 accumulator -> int32 store
//
// The probe asks what the int8 tensor-core rate is against the bf16 rate on
// the same kernel, so both modes share every line but the mma itself.
//
// What bounds it on the H100: operations. At M = K = N = 4096 the product is
// 137.4 GFLOP over 101 MB of inputs and outputs in either mode (bf16 in and
// out; int8 in, int32 out): 0.139 ms at the bf16 peak (989 TFLOP/s), 0.069 ms
// at the int8 peak (1,979 TOP/s), 0.03 ms of bytes.
//
// Design (first version: right and simple). The TPU kernel's grid
// (M/bm, N/bn, K/bk) with K innermost and the accumulator in scratch becomes
// one block per (bm, bn) output tile with the K loop inside it and the
// accumulator in registers; the cast happens once, in the epilogue, as on the
// last K step there. 256 threads (8 warps, 2 along m x 4 along n) walk K one
// (bm x bk) and (bk x bn) tile at a time, double-buffered through shared
// memory with the next tile's global loads in flight in registers while the
// current one multiplies. Both modes run on mma.sync (m16n8k16 bf16, m16n8k32
// int8): their fragments have the same layout in units of 32-bit words (E = 2
// or 4 elements a word), so shared memory is addressed in words and one
// fragment gather serves both.
//   A tile: copied as it is, 16 bytes a thread, into As[m][k-words].
//   B tile: y is (K, N) row-major, but the mma wants consecutive k of one
//   column in one register, and ldmatrix.trans cannot transpose bytes. Each
//   thread loads an E x E block (E rows of k, one 32-bit word of E columns
//   each), transposes it in registers with byte permutes, and stores E words
//   into Bs[n][k-words]: the transposition is part of the timed call.
//   Rows are padded by 4 words, so the fragment gathers (8 rows x 4 words a
//   warp) touch 32 distinct banks; the transposed stores keep a 2-way (bf16)
//   or 4-way (int8) conflict.
// M, N and K must divide the tile (the wrapper refuses other sizes, as
// make_pallas_matmul's m // bm does). wgmma, TMA and a deeper pipeline, the
// only way to the card's full rate, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;     // 8 warps: 2 along m, 4 along n
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int PAD_W = 4;    // words of padding after each shared-memory row

template <typename T>
struct Mode;
template <>
struct Mode<__nv_bfloat16> {
  using Acc = float;
  using Out = __nv_bfloat16;
};
template <>
struct Mode<int8_t> {
  using Acc = int32_t;
  using Out = int32_t;
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(int32_t (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// r[i] holds E elements of row k + i (columns n .. n + E - 1); o[j] gets the
// E elements of column n + j (rows k .. k + E - 1), lowest k in the low bits.
__device__ __forceinline__ void transpose_words(const uint32_t (&r)[2], uint32_t (&o)[2]) {
  o[0] = __byte_perm(r[0], r[1], 0x5410);
  o[1] = __byte_perm(r[0], r[1], 0x7632);
}

__device__ __forceinline__ void transpose_words(const uint32_t (&r)[4], uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  o[0] = __byte_perm(t0, t1, 0x5410);
  o[1] = __byte_perm(t0, t1, 0x7632);
  o[2] = __byte_perm(t2, t3, 0x5410);
  o[3] = __byte_perm(t2, t3, 0x7632);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store_pair(int32_t* p, int32_t a, int32_t b) {
  *reinterpret_cast<int2*>(p) = make_int2(a, b);
}

template <typename T, int BM, int BK, int BN>
struct Tile {
  static constexpr int E = 4 / (int)sizeof(T);       // elements a 32-bit word
  static constexpr int BKW = BK / E;                 // words along k
  static constexpr int PITCH = BKW + PAD_W;          // row pitch in words
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MF = WM / 16, NF = WN / 8;    // mma fragments a warp
  static constexpr int A_CHUNKS = BM * BKW / 4;      // 16-byte chunks of the A tile
  static constexpr int A_PER = (A_CHUNKS + NT - 1) / NT;
  static constexpr int B_UNITS = (BK / E) * (BN / E);  // E x E blocks of the B tile
  static constexpr int B_PER = (B_UNITS + NT - 1) / NT;
  static constexpr int SMEM_BYTES = 2 * (BM + BN) * PITCH * 4;
  static_assert(BKW % 8 == 0, "a k step of the mma is 8 words");
  static_assert(PITCH % 8 == 4, "fragment gathers are conflict-free at 4 * odd");
  static_assert(WM % 16 == 0 && WN % 8 == 0, "warp tile");
  static_assert((BN / E) % 8 == 0 && (BK / E) % 4 == 0, "B loader: 8 x 4 units a warp");
};

// grid (N / BN, M / BM), block NT, dynamic shared memory SMEM_BYTES
template <typename T, int BM, int BK, int BN>
__global__ void __launch_bounds__(NT)
matmul_kernel(const T* __restrict__ x, const T* __restrict__ y,
              typename Mode<T>::Out* __restrict__ out, int M, int K, int N) {
  using Cfg = Tile<T, BM, BK, BN>;
  using Acc = typename Mode<T>::Acc;
  constexpr int E = Cfg::E, BKW = Cfg::BKW, PITCH = Cfg::PITCH;
  constexpr int MF = Cfg::MF, NF = Cfg::NF;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* As = smem;                       // [2][BM][PITCH]
  uint32_t* Bs = smem + 2 * BM * PITCH;      // [2][BN][PITCH], B transposed

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;    // mma fragment coordinates
  const int wm = (warp / WARPS_N) * Cfg::WM, wn = (warp % WARPS_N) * Cfg::WN;
  const size_t m0 = (size_t)blockIdx.y * BM, n0 = (size_t)blockIdx.x * BN;
  const int nk = K / BK;

  uint4 ra[Cfg::A_PER];
  uint32_t rb[Cfg::B_PER][E];

  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < Cfg::A_PER; ++i) {
      const int id = tid + i * NT;
      if (id < Cfg::A_CHUNKS) {
        const int row = id / (BKW / 4), kc = id % (BKW / 4);
        ra[i] = *reinterpret_cast<const uint4*>(x + (m0 + row) * K + k0 + kc * 4 * E);
      }
    }
#pragma unroll
    for (int i = 0; i < Cfg::B_PER; ++i) {
      const int id = tid + i * NT;  // a warp's 32 units: 8 along n x 4 along k
      if (id < Cfg::B_UNITS) {
        const int blk = id >> 5, l = id & 31;
        const int ng = (blk % (BN / E / 8)) * 8 + (l & 7);
        const int kg = (blk / (BN / E / 8)) * 4 + (l >> 3);
        const T* src = y + (size_t)(k0 + kg * E) * N + n0 + ng * E;
#pragma unroll
        for (int r = 0; r < E; ++r)
          rb[i][r] = *reinterpret_cast<const uint32_t*>(src + (size_t)r * N);
      }
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < Cfg::A_PER; ++i) {
      const int id = tid + i * NT;
      if (id < Cfg::A_CHUNKS) {
        const int row = id / (BKW / 4), kc = id % (BKW / 4);
        *reinterpret_cast<uint4*>(&As[(buf * BM + row) * PITCH + kc * 4]) = ra[i];
      }
    }
#pragma unroll
    for (int i = 0; i < Cfg::B_PER; ++i) {
      const int id = tid + i * NT;
      if (id < Cfg::B_UNITS) {
        const int blk = id >> 5, l = id & 31;
        const int ng = (blk % (BN / E / 8)) * 8 + (l & 7);
        const int kg = (blk / (BN / E / 8)) * 4 + (l >> 3);
        uint32_t o[E];
        transpose_words(rb[i], o);
#pragma unroll
        for (int j = 0; j < E; ++j) Bs[(buf * BN + ng * E + j) * PITCH + kg] = o[j];
      }
    }
  };

  Acc acc[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) fetch((kt + 1) * BK);
    const uint32_t* a_s = As + cur * BM * PITCH;
    const uint32_t* b_s = Bs + cur * BN * PITCH;
#pragma unroll
    for (int ks = 0; ks < BKW; ks += 8) {
      uint32_t af[MF][4], bf[NF][2];
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        const uint32_t* p = a_s + (wm + i * 16 + g) * PITCH + ks + t4;
        af[i][0] = p[0];
        af[i][1] = p[8 * PITCH];
        af[i][2] = p[4];
        af[i][3] = p[8 * PITCH + 4];
      }
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const uint32_t* p = b_s + (wn + j * 8 + g) * PITCH + ks + t4;
        bf[j][0] = p[0];
        bf[j][1] = p[4];
      }
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j) mma(acc[i][j], af[i], bf[j]);
    }
    if (kt + 1 < nk) stash(cur ^ 1);
    __syncthreads();
  }

  // the cast of the TPU kernel's last K step
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const size_t r = m0 + wm + i * 16 + g, c = n0 + wn + j * 8 + 2 * t4;
      store_pair(out + r * N + c, acc[i][j][0], acc[i][j][1]);
      store_pair(out + (r + 8) * N + c, acc[i][j][2], acc[i][j][3]);
    }
}

template <typename T, int BM, int BK, int BN>
int launch(const void* x, const void* y, void* out, int M, int K, int N,
           cudaStream_t stream) {
  using Cfg = Tile<T, BM, BK, BN>;
  if (M <= 0 || K <= 0 || N <= 0 || M % BM || K % BK || N % BN)
    return (int)cudaErrorInvalidValue;
  auto kernel = matmul_kernel<T, BM, BK, BN>;
  // above 48 KB a block's shared memory must be asked for; the attribute is
  // per device function and cheap to set again
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM_BYTES);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  const dim3 grid(N / BN, M / BM);
  kernel<<<grid, NT, Cfg::SMEM_BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<typename Mode<T>::Out*>(out), M, K, N);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tile(int tile, const void* x, const void* y, void* out, int M, int K, int N,
                cudaStream_t stream) {
  // the compiled tiles (bm, bk, bn): keep in step with TILES in
  // h36x_torch/ops/matmul_probe.py
  switch (tile) {
    case 0: return launch<T, 128, 64, 128>(x, y, out, M, K, N, stream);
    case 1: return launch<T, 128, 32, 128>(x, y, out, M, K, N, stream);
    case 2: return launch<T, 64, 32, 64>(x, y, out, M, K, N, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// mode: 0 bfloat16 (out bfloat16), 1 int8 (out int32). tile: index into the
// compiled tiles. x (M, K), y (K, N), out (M, N), all row-major, contiguous
// and 16-byte aligned. Returns the launch's CUDA error, or 0.
extern "C" int h36x_matmul_probe(const void* x, const void* y, void* out, int M, int K,
                                 int N, int mode, int tile, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) return launch_tile<__nv_bfloat16>(tile, x, y, out, M, K, N, s);
  if (mode == 1) return launch_tile<int8_t>(tile, x, y, out, M, K, N, s);
  return (int)cudaErrorInvalidValue;
}
