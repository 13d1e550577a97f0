// Tiled tensor-core matmul probe, bf16 and int8, sm_90a: TMA + wgmma.
//
// Replaces the Pallas TPU kernel benchmarks/int8_pallas_probe.py::_matmul_kernel
// (reached through make_pallas_matmul / bench / main): out = x (M, K) . y (K, N),
// both row-major, in two modes on one mainloop:
//
//   bf16 x bf16 -> f32 accumulator -> bf16 store (round to nearest even)
//   int8 x int8 -> int32 accumulator -> int32 store
//
// The probe asks what the int8 tensor-core rate is against the bf16 rate on
// the same kernel, so both modes run the one GEMM of hopper.cuh and differ in
// the wgmma instruction (m64nBNk16 bf16, m64nBNk32 s8) and the epilogue.
//
// What bounds it on the H100: operations. At M = K = N = 4096 the product is
// 137.4 GFLOP over 101 MB of inputs and outputs in either mode (bf16 in and
// out; int8 in, int32 out): 0.139 ms at the bf16 peak (989 TFLOP/s), 0.069 ms
// at the int8 peak (1,979 TOP/s), 0.03 ms of bytes.
//
// Design. hopper.cuh's warp-specialised persistent GEMM: one block of 384
// threads per SM walks the 128 x BN output tiles; a producer thread keeps a
// ring of (128 x 128-byte, BN x 128-byte) tiles in flight by TMA with
// 128-byte swizzle; two consumer warpgroups run wgmma on 64 rows each; the
// TPU kernel's cast on the last K step is the epilogue. bf16 tiles are
// staged in shared memory and stored 16 bytes a thread; int32 pairs go out
// from the registers (32 contiguous bytes per 4 threads).
//   B in bf16: wgmma reads B MN-major (transpose bit), so y's (64 K x 64 N)
//   boxes load as they lie; no transposition.
//   B in int8: wgmma's s8 form takes K-major operands only, so a small kernel
//   first writes yt = y^T (N, K) into a workspace, inside the same call (the
//   probe's question needs the transposition in the timed call, as the
//   earlier design kept it): K x N bytes read and written once, 128 x 128
//   byte tiles turned in registers (4 x 4 byte permutes).
// The tiles (BM, BN) = (128, 256) and (128, 128) are compiled; BK is one
// 128-byte swizzle row (64 bf16, 128 int8). M, N and K must divide the tile
// (the wrapper refuses other sizes, as make_pallas_matmul's m // bm does).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace h36x_hopper;

// bf16 out: staged, 16-byte stores
struct StoreBf16 {
  struct Args {
    __nv_bfloat16* out;
  };
  template <int BN>
  static constexpr int bytes() {
    return staging_bytes<BN>();
  }
  template <int BN>
  __device__ static void store(float (&d)[BN / 2], const Args& a, long long M, int N,
                               long long m0, int n0, uint8_t* stage, int wg, int tid) {
    store_tile_bf16<BN>(d, a.out, M, N, m0, n0, stage, wg, tid,
                        [](int, int, float v0, float v1) { return __floats2bfloat162_rn(v0, v1); });
  }
};

// int32 out: straight from the accumulators, 8 bytes a thread
struct StoreS32 {
  struct Args {
    int32_t* out;
  };
  template <int BN>
  static constexpr int bytes() {
    return 0;
  }
  template <int BN>
  __device__ static void store(int (&d)[BN / 2], const Args& a, long long M, int N,
                               long long m0, int n0, uint8_t*, int, int tid) {
    const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const long long m = m0 + 16 * warp + (lane >> 2) + 8 * i;
        const int n = n0 + 8 * j + 2 * (lane & 3);
        if (m < M)
          *reinterpret_cast<int2*>(a.out + m * N + n) =
              make_int2(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
      }
  }
};

// r[i] holds 4 int8 of row k + i (columns n .. n + 3); o[j] gets the 4 of
// column n + j (rows k .. k + 3), lowest k in the low byte
__device__ __forceinline__ void transpose_4x4(const uint32_t (&r)[4], uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  o[0] = __byte_perm(t0, t1, 0x5410);
  o[1] = __byte_perm(t0, t1, 0x7632);
  o[2] = __byte_perm(t2, t3, 0x5410);
  o[3] = __byte_perm(t2, t3, 0x7632);
}

// yt (N, K) = y (K, N)^T, int8: one 128 x 128 tile per block of 256 threads.
// y's rows come in as 16-byte chunks into shared memory, chunk c of row k
// stored at chunk c ^ (k / 16 % 8) (so that the column reads below hit 32
// distinct banks); each thread then reads a 16 (k) x 4 (n) block as 16
// words, transposes it in registers and writes 4 16-byte chunks of yt, a
// warp covering 4 rows of yt x 128 contiguous bytes.
__global__ void __launch_bounds__(256) transpose_s8(const int8_t* __restrict__ y,
                                                    int8_t* __restrict__ yt, int K, int N) {
  __shared__ uint4 tile[128 * 8];
  const int t = threadIdx.x;
  const long long k0 = (long long)blockIdx.y * 128, n0 = (long long)blockIdx.x * 128;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (t >> 3) + 32 * i, c = t & 7;
    tile[r * 8 + (c ^ ((r >> 4) & 7))] =
        *reinterpret_cast<const uint4*>(y + (k0 + r) * N + n0 + 16 * c);
  }
  __syncthreads();
  const int kc = t & 7, g = t >> 3;  // rows 16 kc .. + 15 of y, columns 4 g .. + 3
  uint32_t o[4][4];                  // o[e][q]: column 4 g + e, rows 16 kc + 4 q .. + 3
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t r[4], c[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int row = 16 * kc + 4 * q + b;
      r[b] = reinterpret_cast<const uint32_t*>(&tile[row * 8 + ((g >> 2) ^ kc)])[g & 3];
    }
    transpose_4x4(r, c);
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e][q] = c[e];
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    *reinterpret_cast<uint4*>(yt + (n0 + 4 * g + e) * K + k0 + 16 * kc) =
        make_uint4(o[e][0], o[e][1], o[e][2], o[e][3]);
}

int transpose(const void* y, void* yt, int K, int N, cudaStream_t stream) {
  if (K <= 0 || N <= 0 || K % 128 || N % 128) return (int)cudaErrorInvalidValue;
  transpose_s8<<<dim3(N / 128, K / 128), 256, 0, stream>>>(static_cast<const int8_t*>(y),
                                                            static_cast<int8_t*>(yt), K, N);
  return (int)cudaGetLastError();
}

template <int BN>
int run_bf16(const void* x, const void* y, void* out, int M, int K, int N,
             cudaStream_t stream) {
  using G = Gemm<__nv_bfloat16, BN, true, false, StoreBf16>;
  typename G::P p{};
  int err = make_map(&p.a[0], x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, K, M, 2ull * K, 64, BM);
  if (!err) err = make_map(&p.b[0], y, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, N, K, 2ull * N, 64, 64);
  if (err) return err;
  p.M = M;
  p.N = N;
  add_seg(p, 0, 0, K);
  p.epi.out = static_cast<__nv_bfloat16*>(out);
  return launch_gemm<G>(p, stream);
}

template <int BN>
int run_s8(const void* x, const void* y, void* y_ws, void* out, int M, int K, int N,
           cudaStream_t stream) {
  using G = Gemm<int8_t, BN, false, false, StoreS32>;
  int err = transpose(y, y_ws, K, N, stream);
  if (err) return err;
  typename G::P p{};
  err = make_map(&p.a[0], x, CU_TENSOR_MAP_DATA_TYPE_UINT8, K, M, (uint64_t)K, 128, BM);
  if (!err)
    err = make_map(&p.b[0], y_ws, CU_TENSOR_MAP_DATA_TYPE_UINT8, K, N, (uint64_t)K, 128, BN);
  if (err) return err;
  p.M = M;
  p.N = N;
  add_seg(p, 0, 0, K);
  p.epi.out = static_cast<int32_t*>(out);
  return launch_gemm<G>(p, stream);
}

// the compiled tiles: keep in step with TILES in h36x_torch/ops/matmul_probe.py
constexpr int TILE_BN[] = {256, 128};

template <int BN>
int run(const void* x, const void* y, void* y_ws, void* out, int M, int K, int N, int mode,
        cudaStream_t stream) {
  const int bk = mode == 0 ? 64 : 128;
  if (M <= 0 || K <= 0 || N <= 0 || M % BM || N % BN || K % bk) return (int)cudaErrorInvalidValue;
  if (mode == 0) return run_bf16<BN>(x, y, out, M, K, N, stream);
  if (mode == 1) return run_s8<BN>(x, y, y_ws, out, M, K, N, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// mode: 0 bfloat16 (out bfloat16), 1 int8 (out int32). tile: index into the
// compiled tiles. x (M, K), y (K, N), out (M, N), all row-major, contiguous
// and 16-byte aligned; y_ws: (N, K) int8 workspace for int8 (unused, may be
// NULL, for bfloat16). Returns the first launch's CUDA error, or 0.
extern "C" int h36x_matmul_probe(const void* x, const void* y, void* y_ws, void* out, int M,
                                 int K, int N, int mode, int tile, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 1 && y_ws == nullptr) return (int)cudaErrorInvalidValue;
  switch (tile) {
    case 0: return run<TILE_BN[0]>(x, y, y_ws, out, M, K, N, mode, s);
    case 1: return run<TILE_BN[1]>(x, y, y_ws, out, M, K, N, mode, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
